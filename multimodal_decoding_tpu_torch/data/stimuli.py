"""Stimulus tables & permutation-index factories.

The COCO ids and imagery-scene assignments are experiment data shared with the
reference (its data.py:27-189); they are part of the dataset
contract, not code.  The shuffled-index factory reproduces the reference's
seeded numpy sampling bit-exactly (data.py:540-561) so null distributions are
comparable across frameworks.
"""

from __future__ import annotations

import numpy as np

from multimodal_decoding_tpu_torch.config import CAPTION, IMAGE, IMAGERY

IMAGERY_SCENES = {
    "sub-01": [
        ("A woman sits in a beach chair as a man walks along the sand", 406591),
        ("White bird sitting in front of a lighthouse with a red roof", 324670),
        ("A little cat standing on the lap of a man sitting in a chair", 563723),
    ],
    "sub-02": [
        ("A woman sits in a beach chair as a man walks along the sand", 406591),
        ("A little cat standing on the lap of a man sitting in a chair", 563723),
        ("A lonely giraffe is walking in the middle of a grassy field", 254568),
    ],
    "sub-03": [
        ("A party of young people in a bedroom with a large box of pizza", 42685),
        ("A man walking across a field of snow holding skis and ski poles", 473773),
        ("Two men are discussing something next to a desk with a laptop", 485909),
    ],
    "sub-04": [
        ("A young male holding a racket and tennis ball in a tennis court", 544502),
        ("A group of kids swimming in the ocean around a man on a surfboard", 556512),
        ("A cat and a dog staring intensely at each other on an armchair", 410573),
    ],
    "sub-05": [
        ("A man stands by a rainy street with an umbrella over his head", 48670),
        ("A woman working on her computer while also using her cell phone", 263212),
        ("An old broken down church and graffiti on surrounding structures", 214816),
    ],
    "sub-07": [
        ("A teddy bear lying down on the sidewalk in front of a store", 141343),
        ("A woman leaning out a window to talk to someone on the sidewalk", 213506),
        ("The man on the skateboard and the dog are getting their picture taken", 162396),
    ],
}

IMAGERY_STIMS_IDS = {sub: [s[1] for s in scenes] for sub, scenes in IMAGERY_SCENES.items()}
IMAGERY_STIMS_TYPES = {sub: [IMAGERY for _ in scenes] for sub, scenes in IMAGERY_SCENES.items()}

# fmt: off
IDS_IMAGES_TEST = [
    3862, 6450, 16764, 25902, 38938, 43966, 47566, 53580, 55413, 57703,
    63881, 70426, 79642, 122403, 133449, 138529, 146411, 159225, 163240,
    165419, 165874, 176509, 180389, 183210, 186308, 186788, 192095, 195406,
    201601, 211189, 220654, 221313, 238193, 252018, 255714, 271844, 275995,
    278135, 279331, 287434, 292888, 310552, 315083, 318108, 323797, 353260,
    363483, 367120, 380011, 385795, 388398, 414373, 423618, 450719, 454636,
    457249, 466514, 467854, 475693, 499733, 505655, 512289, 534975, 536798,
    546074, 548167, 555739, 560282, 567627, 573980,
]
# fmt: on

NUM_TEST_STIMULI = len(IDS_IMAGES_TEST) * 2
INDICES_TEST_STIM_CAPTION = list(range(NUM_TEST_STIMULI // 2))
INDICES_TEST_STIM_IMAGE = list(range(NUM_TEST_STIMULI // 2, NUM_TEST_STIMULI))

TEST_STIM_IDS = np.array(IDS_IMAGES_TEST + IDS_IMAGES_TEST)
TEST_STIM_TYPES = np.array(
    [CAPTION] * len(INDICES_TEST_STIM_CAPTION) + [IMAGE] * len(INDICES_TEST_STIM_IMAGE)
)

# Random imagery derangements used inside null-distribution scoring
# (searchlight.py:35,65-66)
DERANGEMENTS_THREE_DIMS = [[1, 2, 0], [2, 0, 1]]


def create_shuffled_indices(seed: int) -> np.ndarray:
    """Seeded within-modality shuffle of the 140 test indices (data.py:554-561)."""
    np.random.seed(seed)
    num_stim_one_mod = NUM_TEST_STIMULI // 2
    shuffle_mod_1 = np.random.choice(range(num_stim_one_mod), size=num_stim_one_mod, replace=False)
    shuffle_mod_2 = np.random.choice(
        range(num_stim_one_mod, NUM_TEST_STIMULI), size=num_stim_one_mod, replace=False
    )
    return np.concatenate((shuffle_mod_1, shuffle_mod_2))


def create_null_distr_shuffled_indices(n_permutations_per_subject: int) -> list:
    """Derangement-style shuffles, seed-scanned exactly like data.py:540-551."""
    shuffled_indices = []
    seed = 0
    for _ in range(n_permutations_per_subject):
        indices = create_shuffled_indices(seed)
        while any(indices == np.arange(NUM_TEST_STIMULI)):
            seed += 1
            indices = create_shuffled_indices(seed)
        shuffled_indices.append(indices)
        seed += 1
    return shuffled_indices
