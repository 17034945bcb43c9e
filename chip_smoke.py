"""Start-up proof of the PyTorch port (multimodal_decoding_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. build   - compile every source under csrc/ with nvcc, one process each,
             all started together; one {"ptxas": [...]} line gives each
             kernel's registers, spills and static shared memory, and one
             {"sass_hgmma": {...}} line each kernel's HGMMA (wgmma)
             instructions in cuobjdump's SASS: every tensor-core
             instantiation must have some, and no spills.
2. kernel  - each kernel against its plain PyTorch version on the card at the
             main path's shapes: max error, CUDA-event median times of the
             kernel, the plain version and one library yardstick (and their
             ratio, library_ratio = kernel ms / library ms), and the least
             time the card could take (bound).  chol_inv_panel runs at
             [128, 188|187] (the searchlight's schur-pallas base blocks),
             [128, 64] (the blocked_spd_inverse panel), [6, 103|102] (the
             whole-brain CV's base blocks) and [128, 101|100|99] (radius
             mode's base blocks at fsaverage7 density).  The
             streamed-count kernels must give counts equal to the plain
             version on integer-valued inputs and accuracies within 1e-5 on
             Gaussian ones; streamed_acc_from_inv's Z GEMM and count are also
             timed apart, each beside its cuBLAS product.
3. gate    - two runner blocks (B=128) at full width (N=8192 train, 140 test,
             3 imagery, K=750, D=1024, 6 alphas x 5 folds, 100 shuffles),
             once with the shipped "schur-pallas" selection and once with the
             strict Cholesky selection, on a planted signal whose strength
             varies over the sphere: at least 3 distinct alphas selected,
             alpha agreement >= 0.998, CV-score delta <= 1e-5, final-score
             delta <= 1e-4, and 240 kernel launches (2 blocks x 120).
4. scorers - the streamed-count selection path: the gate's problem and blocks
             through run_searchlight with cv_scorer "pallas", "fused",
             "fused-pallas" and "fused-inv" (and "xla" beside them) on the
             "schur-pallas" solver, each held to the strict path: agreement
             >= 0.998, >= 3 distinct alphas, CV-score delta <= 1e-5 ("pallas")
             or 5e-5 ("fused*", reassociated through K), final-score delta
             <= 1e-4, and exact launch counts (60 of the scorer's kernel, 240
             of chol_inv_panel); prints vertices/s per scorer.
5. cli     - the port's searchlight CLI in-process, on a synthetic subject at
             full width on icosphere(4) (2,562 vertices per hemisphere, the
             only cut from production's 163,842), with --n-neighbors 750,
             the 6-alpha CV and 100 null shuffles; checks the artifacts, the
             planted-signal accuracies and that only chol_inv_panel ran.
6. radius  - radius mode at fsaverage7's density: radius_adjacency on the card
             over icosphere(7) (163,842 vertices, radius 100) at the radius
             whose balls hold ~750 vertices on average (derived here: the
             uniform-sphere estimate corrected by exact host counts), its
             seconds, Kmean, Kmax and pad waste Kmax/Kmean, and each
             vertex's count against scipy's float64 cKDTree (every flipped
             neighbour within float32 rounding of r^2); two blocks of B=128
             of those neighbourhoods (vertices along a meridian, so the
             gate's pole-to-pole signal grades each block), padded to Kmax
             and masked, through searchlight_block_cv_with_null at full
             width against the same vertices with
             the pad columns dropped, one call per count: CV grids within
             1e-5, alphas equal but at a selection near-tie (the masked
             pick first within the tie band once the column drop's grid
             moves by twice the vertex's grid delta), and where the alphas
             agree each metric's final scores within 1e-4 and nulls equal
             unless its rank counts hold a float64 near-tie (< 1e-5; the
             excused vertices' gaps printed);
             chol_inv_panel's launches and shapes (Kmax halves three times
             to [128, ~100]: 240 a block), held to its plain version on
             the path's own masked inputs; the null gathers "gather",
             "onehot" and "onehot-bf16" bit for bit (whole blocks, and the
             null scoring alone at P = 100 and 1000), each one's ms, and the
             masked block's ms beside the n-neighbours block at K = 750;
             then the searchlight CLI with --radius on phase cli's data set
             (its own if cli did not run) at Kmean ~750: the results path
             radius_<r>, the JAX package's pickle keys, int32 n_neighbors,
             distances None, exact launches, vertices/s, and its first block
             held to the column drop of the inputs the CLI read.
7. wb_gate - the whole-brain selection gate: 16 planted-signal decode problems
             (n=8192 stimuli, f=16384 features, D=1024, noise swept from strong
             signal to near-noise), each CV'd by ridge_cv_dual with the strict
             Cholesky oracle and with the shipped "schur-pallas" selection:
             the same best alpha on every problem, >= 3 distinct alphas,
             CV-score and final-score deltas <= 1e-4, and exactly 320
             chol_inv_panel launches per fast CV (64 base blocks of PB 102/103
             per fold x 5 folds), every one a contiguous [6, PB, PB] tensor on
             the card and none through the plain version.
8. precision - the TPU's reduced-precision selection path at full width (the
             gate's problem: N=8192, 140 test, 3 imagery, K=750, D=1024, B=128,
             6 alphas x 5 folds, 100 shuffles): each streamed-count kernel at
             "default" (one bf16 pass on the tensor cores: wgmma on bf16
             planes) and "high" (bf16 x 3), with float32 and bf16 first
             operands (a bf16 Xv_b in the engine's padded rows, loaded by
             tensor map; streamed_acc_from_factors also with Z's bf16 planes,
             the form the selection hands over), against its plain version at that
             precision (counts equal on integer inputs in -16..16,
             accuracies within 1e-5 on Gaussian ones; CUDA-event ms, the
             bf16 bound at 989 TFLOP/s, the plain version's ms and a library
             yardstick, one bf16 cuBLAS product with float32 output; the
             rounding into planes, the Z GEMM (B4's, and factor_planes, the
             producer of B5's planes) and the count timed apart;
             the rounding kernel bit for bit against its plain version on
             every operand the wrapper rounds, at these shapes);
             "schur-cb16", "schur-cb16-ns" and "tri-inv" at [128, 750] against
             Cholesky over the 6 production alphas within the JAX package's
             bands (2e-2, 2e-4, 5e-5 at "highest"; "default" printed); the
             gate's 2 blocks through run_searchlight with bf16 selection
             storage on "schur-pallas" at "default" (scorers xla, pallas,
             fused-pallas, fused-inv) and at "high" (the streamed ones), each
             against the strict path: the agreement printed beside the JAX
             package's 0.95 and the default gate's 0.998, where the alphas
             differ the strict CV accuracy given up <= 1e-3, final scores
             bitwise equal where they agree, 240 chol_inv_panel launches and
             60 of the scorer's kernel at that precision, and fused-pallas
             equal to fused-inv (the same Z planes into the same count:
             alphas, CV grids, final and null scores bit for bit); the searchlight
             CLI with --fast-math on phase cli's data set: X_all stored in
             bf16 (its dtype and device bytes as the block steps read it),
             each map's mean |final score - phase cli's| <= 0.02, vertices/s
             and alpha agreement printed; ridge_cv_dual at
             "default" on phase wb_gate's 16 problems (agreement with their
             strict alphas); last, the tensor-core edge cases: nv 1/64/65/129
             and 1536/1537/1600/1639/1700 (every width of the last column
             tile: 64, 128, 192, 256) x depth 16/17/750 (and D = 1024) at
             both precisions for each first-operand layout and, for
             streamed_acc_from_factors, Z as float32 and as its planes, and
             the rounding kernel on ragged views.
             It needs phases cli and wb_gate before it.
9. wb      - one whole-brain decode at production scale: N=8192 train, 140
             test, 3 imagery, V=327,684 (both fsaverage7 hemispheres), D=1024,
             6 alphas x 5 folds, from host numpy betas (10.7 GB) streamed into
             the gram; prints seconds per stage (gram and query kernels, CV
             selection, refit, predictions, score family) and the launches.
10. wb_cli - the port's whole-brain CLI in-process on a synthetic subject
             (N=8192, D=1024, both hemispheres of icosphere(4) with --surface:
             the vertex count is the only cut): results.p at the contract path
             with the JAX package's schema, planted-signal accuracies > 0.9, a
             rerun that skips, 320 chol_inv_panel launches and no other kernel.
11. stats  - the group statistics at production width: seeded null scores
             [6 subjects, 100 nulls, 163,842 vertices] of the 4 member metrics
             of mod_agnostic_and_cross on both hemispheres (with NaN and
             degenerate vertices), swept through the port's null sweep
             (ops/stats.null_min_t_sweep) over the first 10,000 group
             permutations in chunks of 256: seconds a hemisphere, its bound and
             share of it, peak device memory; 8 sampled permutations held to a
             float64 numpy t-map (equal NaN patterns, max |dt| <= 1e-5 max |t|);
             host TFCE (native/tfce.cpp) over the first 512 min-maps of each
             hemisphere on icosphere(7) edges: ms a map, threads, projection.
12. study  - the port's study CLI in-process on 6 synthetic planted-signal
             subjects (both hemispheres of icosphere(3), 256 train stimuli,
             K=375 neighbours, D=1024, 100 nulls each, the 6-alpha CV): every
             artifact at the JAX package's paths, significant vertices, a
             rerun that skips every stage, the exact chol_inv_panel launch
             count of the Schur recursion at K, no streamed-count launch,
             the permutation CLI on the same searchlight outputs giving the
             same null_max and p-values, and the export CLI writing every
             subject, average and min-composite GIfTI map, each read back
             equal to the map it came from.
13. ingest - streamed betas ingestion at production width, nothing cut: one
             fsaverage7 hemisphere (8,192 train + 140 test + 3 imagery rows x
             163,842 vertices, 1% NaN columns, a planted signal from a seed)
             written as the betas npz caches (5.46 GB, row chunk by row
             chunk); the streamed statistics and device X_all
             (parallel/ingest.py) against the eager load + standardisation +
             upload: statistics bitwise equal, torch.equal of the two card
             tensors, and the bf16 stream of fast math torch.equal to the
             eager tensor cast to bf16; seconds of each pass, file-read and
             H2D GB/s, host peak
             RSS growth of each path; then 2 runner blocks (B = 128, K = 750,
             6 alphas, 100 nulls) from each tensor: equal outputs, 240
             chol_inv_panel launches from the streamed one.
14. dist   - the multi-GPU paths on a world of one NCCL rank (one card holds
             one rank): the gate's 2 blocks through run_searchlight(mesh=...)
             against mesh=None (alphas and nulls equal, scores within rtol
             2e-5 / atol 2e-6, 240 launches), the whole-brain CLI with
             --multichip on phase wb_cli's data set (equal accuracies and
             predictions, 320 launches), the permutation CLI with --sharded
             on phase study's searchlights (equal null_max and p-values),
             entry() and dryrun_multichip(1) with its step (3b), bf16
             selection storage at "default"; wall seconds of each sharded
             run beside its unsharded one.  It needs phases wb_cli and study
             before it in the same call.
15. analyses - the analyses on the card: the Monte-Carlo t calibration at
             the reference's production shape (10,000 permutations x 6
             subjects x (73 latents + 3 predictions) x 1024 = 4.67e9
             normals), its draws held bit-equal to the numpy draws on one
             chunk, its cutoffs and minimum accuracies within 1e-4 relative
             of the JAX package's values for the same seed (recorded below);
             the two-modality simulation's ridge classifier at full width
             (2 conditions x 3 decoders x 2 seeds) against the same fits on
             the CPU (labels >= 0.999 equal), host data and card seconds
             apart and run_all_conditions(n_seeds=10) projected; CSLS on
             [140, 1024] x [140, 1024], knn 100, against the CPU (1e-5);
             no hand-written kernel runs on this path.
16. extract - feature extraction: the random-imagebind control built on the
             card from seed 0 through the extractor registry at
             ImageBind-Huge's full width (~0.98e9 weights, drawn as the JAX
             package draws them; 1.05e6 sampled weights bit-equal to numpy
             threefry), its forward at batch 10 (the registry's) and 128 on
             seeded pixels and token ids (ms a batch, stimuli/s, peak memory,
             the float32 FLOP bound), batch 2 against the same modules in
             float64 (vision max |d| <= 1e-4, text <= 1e-4 x the logit
             scale), the extraction harness over 3 batches of 10 read back by
             the data layer, the Gabor bank on 100 images of 256 x 256
             (against float64 and scipy.ndimage) and motion energy on 100 of
             96 x 96 (against float64); no hand-written kernel runs on it.

17. examples - the port's examples (multimodal_decoding_tpu_torch/examples) on
             the card at their own sizes, full_pipeline (steps 1-3; the
             figure only where matplotlib is installed), model_comparison,
             roi_decoding and nearest_neighbor_ranking (on the card run's
             model_comparison pickle), each against a --device cpu run of
             the port in this phase: the same printed lines (the numbers
             included) once temporary paths, the device tag and timings are
             spelled alike; chol_inv_panel launched on the card by the
             first three, no kernel by the CPU runs.

On request, ``--phases build,profile [--scorer fused-pallas] [--precision
default]`` breaks one main-path block step down by kernel (torch.profiler;
at default or high with bf16 selection storage), and ``--phases
build,wb_profile`` does the same for the whole-brain stages: the streamed
gram over 8 column blocks (device busy share: is the host copy in the way?),
one fast and one strict CV at N=8192.  ``--phases flips`` draws the
analyses' production null once more, prints its count digest beside the JAX
package's and counts the comparisons d_ii < d_ij that flip between float32
and float64 on the card.

Then it prints the card's name and power limit (nvidia-smi), one
{"kernels": [...]} line, and as its last line
{"ok": true, "device": {"platform": "gpu", ...}}.  Any failed check raises
and the exit code is not 0.  Without a CUDA device, or outside a checkout of
the repository, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "kernel", "gate", "scorers", "cli", "radius", "wb_gate", "precision", "wb",
          "wb_cli", "stats", "study", "ingest", "dist", "analyses", "extract", "examples")
EXTRA_PHASES = ("profile", "wb_profile", "flips")  # run on request: --phases build,profile
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

KERNEL_TOL = 1e-4         # max |kernel - plain| / max |plain|
# streamed counts, Gaussian inputs: a flipped near-tie moves an accuracy by
# 1/(nv^2 - nv) = 3.7e-7 at nv = 1639; float32 sums in another order flip few
ACC_TOL = 1e-5
ALPHA_AGREEMENT_MIN = 0.998
CV_SCORE_DELTA_MAX = 1e-5  # per (vertex, alpha) CV accuracy
FUSED_CV_SCORE_DELTA_MAX = 5e-5  # the fused* scorers reassociate sim through K
SCORE_DELTA_MAX = 1e-4
MIN_DISTINCT_ALPHAS = 3    # the gate must see the selection pick across the grid
ALPHAS = [1e2, 1e3, 1e4, 1e5, 1e6, 1e7]
N_TRAIN, N_TEST, N_IMAG, K, D, B, P = 8192, 140, 3, 750, 1024, 128, 100
LAUNCHES_PER_BLOCK = 120  # chol_inv_panel: 4 base blocks per Schur inverse x 6 alphas x 5 folds
SCORER_CALLS_PER_BLOCK = 30  # a streamed scorer's kernel: 6 alphas x 5 folds
NV = 1639  # the largest validation fold of N_TRAIN = 8192 (KFold, 5 splits)
STREAMED_SCORERS = {"pallas": "streamed_pairwise_acc", "fused": None,
                    "fused-pallas": "streamed_acc_from_factors",
                    "fused-inv": "streamed_acc_from_inv"}
# the whole-brain decode: 8192 train stimuli, 327,684 vertices (both
# fsaverage7 hemispheres); its gate's problems have 16,384 features
WB_V, WB_GATE_F, WB_GATE_REPS = 327_684, 16_384, 16
WB_CV_DELTA_MAX = 1e-4
# streamed gram and query kernels vs float64 on sampled rows: float32 sums
# over 327,684 columns in 16,384-column blocks
WB_KERNEL_TOL = 1e-5
WB_NOISE = 24.0  # the decode phase's noise per vertex; the signal's is 1
# 5 folds x 64 base blocks: n_tr = 6553|6554 halves six times to PB 102|103
WB_LAUNCHES = 320
WB_BASE_SHAPES = [(6, 103), (6, 102)]  # chol_inv_panel [A=6, PB, PB] on that path
# radius mode at fsaverage7 density: Kmax ~ 800 halves three times to ~100
# (Kmax 804 at r = 13.47 on icosphere(7) gives 101|100; 797-800 give 100|99)
RADIUS_BASE_SHAPES = [(B, 101), (B, 100), (B, 99)]
# group statistics at production width: subjects, nulls a subject, fsaverage7
# vertices a hemisphere, group permutations and the sweep's chunk
ST_S, ST_P, ST_V, ST_GROUP, ST_CHUNK = 6, 100, 163_842, 10_000, 256
ST_ICO = 7  # icosphere(7) has fsaverage7's 163,842 vertices
ST_CHECK_PERMS, ST_TFCE_MAPS = 8, 512
ST_T_TOL = 1e-5  # max |t - t_float64| / max |t_float64|
# the study: 6 subjects on icosphere(3) (642 vertices a hemisphere), 256 train
# stimuli, K = 375 (base blocks 188|187, the searchlight's own panel shapes)
SD_SUBJECTS, SD_ICO, SD_N_TRAIN, SD_K = 6, 3, 256, 375
SD_GROUP, SD_P_THRESHOLD = 10_000, 1e-3  # the least p of 10,000 is 1e-4
SD_FOLDS = 5
# streamed ingestion: one fsaverage7 hemisphere, 1% NaN (medial-wall) columns,
# written and generated in chunks of IN_CHUNK rows
IN_V, IN_NAN_SHARE, IN_CHUNK = 163_842, 0.01, 512
# a vertex-sharded runner may pick other cuBLAS kernels at batch B / W
# (tests/test_multiprocess_distributed.py's bar)
DIST_RTOL, DIST_ATOL = 2e-5, 2e-6
# the analyses: the Monte-Carlo t calibration at the reference's production
# shape (10,000 permutations of 6 subjects, 73 latents, 3 predictions, 1024
# dimensions; 4.67e9 normals), 216 = 3 x 73 - 3 pairwise comparisons a subject
AN_PERMS, AN_S, AN_L, AN_P, AN_D = 10_000, 6, 73, 3, 1024
AN_DENOM = AN_P * AN_L - min(AN_P, AN_L)
AN_P_VALS = (0.05, 1e-2, 1e-3, 1e-4)
# The JAX package's values for the same call, computed on the CPU with
#   JAX_PLATFORMS=cpu python -c "from multimodal_decoding_tpu.analysis.calibration
#   import t_threshold_monte_carlo as f; print(f(seed=0))"
AN_JAX_CUTOFFS = {0.05: (2.0205559730529785, 0.5378086566925049),
                  0.01: (3.6013646125793457, 0.5671296119689941),
                  0.001: (6.159075736999512, 0.5794752836227417),
                  0.0001: (15.833959579467773, float("nan"))}
# and the digest of its null's integer counts: with accs [10000, 6] the
# per-permutation pairwise_accuracy of that function's one_perm (jit, vmap,
# chunks of 200) and c = round(accs * 216), (c.sum(), (c * (arange(60000) +
# 1).reshape(10000, 6)).sum()); equal digests mean no comparison flipped
AN_JAX_COUNT_DIGEST = (6485936, 194579890218)
AN_CUTOFF_RTOL = 1e-4
# the simulation: 2 of the 12 conditions at full width (70 classes, 100 / 1000
# samples a class, 200 voxels), 2 seeds, labels held to the CPU's fits
AN_SIM_CONDITIONS, AN_SIM_SEEDS = ("gauss_same_stddev", "just_noise"), 2
AN_LABEL_AGREEMENT_MIN = 0.999
AN_KNN, AN_CSLS_TOL = 100, 1e-5  # CSLS on [140, 1024] x [140, 1024]
# feature extraction: ImageBind-Huge at full width, random-init control from
# seed 0; forwards at the registry's batch and at 128; 1e6 sampled weights
# held to numpy threefry; float64 on the card at batch 2; the harness over 3
# batches of 10; the Gabor bank (160 kernels of 43 x 43) on the CLI's 100
# images of 256 x 256; motion energy (1,361 channels) on 100 of 96 x 96
EX_SEED, EX_BATCHES, EX_F64_BATCH, EX_HARNESS_BATCHES = 0, (10, 128), 2, 3
EX_SAMPLE = 350_000  # sampled weights of each of patch_w, token_embed, block 31's fc1_w
EX_EMBED_TOL = 1e-4  # max |float32 - float64| of a unit vector (x the logit scale for text)
EX_BANK_N, EX_GABOR_PX, EX_MOTEN_PX, EX_SCIPY = 100, 256, 96, (2, 6)
# float32 against float64 sums: within 1e-5 of the float32 error scale (the
# sum of the terms' magnitudes; see gabor_error_scale and moten_error_scale)
EX_BANK_TOL = 1e-5
STREAMED = [  # (kernel, TPU kernel it replaces)
    ("streamed_pairwise_acc", "multimodal_decoding_tpu/ops/pallas_metrics.py:74"),
    ("streamed_acc_from_inv", "multimodal_decoding_tpu/ops/pallas_metrics.py:157"),
    ("streamed_acc_from_factors", "multimodal_decoding_tpu/ops/pallas_metrics.py:230"),
]
# the reduced-precision selection path: the tensor-core variants of the
# streamed counts, the bf16 solvers and the bf16 selection storage
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet, 700 W)
TC_PRECISIONS = ("default", "high")

# the JAX package's agreement bar for bf16 selection, set on its own strong
# planted signal (tests/test_searchlight.py:297-332, held on the port by
# tests/test_torch_precision.py); printed here, where the gate's graded
# signal leaves many vertices with near-tied alphas (on such a signal the
# JAX package's own bf16 selection falls below it too, alpha for alpha with
# the port: tests/test_torch_precision.py::test_cv_bf16_selection_on_a_graded_signal)
PRECISION_AGREEMENT_BAR = 0.95
# where the bf16 selection picks another alpha than the strict path, the
# strict CV accuracy it gives up: at most 1e-3 (at nv = 1639, ~2,700 of the
# 2.7e6 comparisons of a fold), below the two decimals the CLIs report
SELECTION_REGRET_MAX = 1e-3
# --fast-math against the float32 CLI run: the mean |score delta| of each
# map, tests/test_torch_fast_math.py's bar (an imagery accuracy moves in
# steps of 1/6, so one flipped near-tie moves a vertex by that much)
FAST_MATH_SCORE_DELTA_MAX = 0.02
# the JAX package's bands against Cholesky (tests/test_solvers.py:59-60)
SOLVER_BANDS = {"tri-inv": 5e-5, "schur-cb16": 2e-2, "schur-cb16-ns": 2e-4}
# the tensor-core edge cases' nv: one row or column tile and one past it, and
# the last column tile at each width it takes (64, 128, 192, 256 columns)
EDGE_NV = (1, 64, 65, 129, 1536, 1537, 1600, 1639, 1700)
PRECISION_SCORERS = {"default": ("xla", "pallas", "fused-pallas", "fused-inv"),
                     "high": ("pallas", "fused-pallas", "fused-inv")}
# radius mode at fsaverage7's density: icosphere(7) (163,842 vertices, radius
# 100) at the radius whose balls hold ~750 vertices on average, the
# reference's patch size; RD_SAMPLE vertices' exact counts refine the radius
RD_ICO, RD_KMEAN, RD_SAMPLE = 7, 750, 4096
# float32 |q|^2 - 2 q.p + |p|^2 (io/surface.py::_sq_dists) against a float64
# count: a neighbour may flip where |d^2 - r^2| is within a few float32
# roundings of the terms' magnitude (|q| + |p|)^2
RD_FLIP_ULPS = 8
# nulls of a masked block equal the column drop's except at a vertex whose
# rank counts compare two float64 distances closer than this (a near-tie)
RD_TIE_GAP = 1e-5
# the JAX package's searchlight results pickle (decoding/searchlight.py:425-435)
SL_RESULT_KEYS = ("nan_locations", "adjacency", "n_neighbors", "distances", "score_maps",
                  "scores", "best_alpha", "elapsed_s", "vertices_per_sec")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Workspace:
    """Scratch directories that outlive their phase: phase ``dist`` reruns the
    CLIs on the data sets of phases ``wb_cli`` and ``study``."""

    def __init__(self, root: str):
        self.root, self.runs = root, {}

    def dir(self, name: str) -> str:
        path = os.path.join(self.root, name)
        os.makedirs(path)
        return path


WS: Workspace | None = None  # set by main() for the phases of one call


def cuda_time_ms(fn, reps: int = 25, warmup: int = 3, per_sample: int = 1) -> float:
    """Median CUDA-event time of one call of ``fn``, over ``reps`` samples of
    ``per_sample`` calls back to back (a sub-millisecond kernel is timed in
    batches, so the card stays busy and at its clock between the events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / per_sample)
    times.sort()
    return times[len(times) // 2]


def spd_batch(b: int, pb: int, alpha: float, seed: int):
    """[b, pb, pb] float32 grams of 8192 random rows plus alpha I, on the card."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    X = torch.randn((b, N_TRAIN, pb), generator=gen, device=DEVICE)
    return X.mT @ X + alpha * torch.eye(pb, device=DEVICE)


def phase_build() -> dict:
    from concurrent.futures import ThreadPoolExecutor

    from multimodal_decoding_tpu_torch.ops import _cuda_build, _host_build

    # the host TFCE library (g++) builds beside the nvcc builds
    with ThreadPoolExecutor(max_workers=1) as pool:
        tfce = pool.submit(_host_build.build, "tfce.cpp", True)
        libs = _cuda_build.build_all(force=True, verbose=True)
        libs["tfce.cpp"] = tfce.result()
    if sorted(libs) != ["chol_inv_panel.cu", "streamed_count.cu", "tfce.cpp"]:
        raise AssertionError(f"unexpected sources {sorted(libs)}")
    # registers, spills and static shared memory of every kernel, one line
    report = _cuda_build.ptxas_report()
    emit({"ptxas": report})
    hgmma = sass_hgmma(libs["streamed_count.cu"])
    emit({"sass_hgmma": hgmma})
    tc = {k: n for k, n in hgmma.items() if "tc_kernel" in k}
    if len(tc) != 5 or not all(tc.values()):
        raise AssertionError(f"streamed_count.cu: expected 5 tc_kernel instantiations, each "
                             f"with HGMMA in its SASS; cuobjdump shows {hgmma}")
    tc_rows = [r for r in report if "tc_kernel" in r["kernel"]]
    spilled = [r for r in tc_rows if r["spill_store_bytes"] != 0 or r["spill_load_bytes"] != 0]
    if len(tc_rows) != 5 or spilled:
        raise AssertionError(f"streamed_count.cu: expected 5 tc_kernel instantiations, none "
                             f"spilling; ptxas reports {tc_rows}")
    return {"libraries": {src: os.path.relpath(p, ROOT) for src, p in libs.items()},
            "tc_kernel_hgmma": tc}


def sass_hgmma(lib: str) -> dict:
    """HGMMA (wgmma) instructions in the SASS of each kernel of ``lib``, as
    ``cuobjdump -sass`` lists them, by demangled kernel name."""
    from multimodal_decoding_tpu_torch.ops import _cuda_build

    tool = os.path.join(os.path.dirname(_cuda_build._nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True)
    counts, name = {}, None
    for line in proc.stdout.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            counts[name] = 0
        elif name is not None and "HGMMA" in line:
            counts[name] += 1
    return dict(zip(_cuda_build._demangle(list(counts)), counts.values()))


def phase_kernel() -> dict:
    out = {"shapes": kernel_chol_inv_panel()}
    for name, _ in STREAMED:
        out[name] = kernel_streamed(name)
    return out


def kernel_chol_inv_panel() -> list:
    import torch

    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H

    shapes = []
    for b, pb in [(B, 188), (B, 187), (B, 64), *WB_BASE_SHAPES, *RADIUS_BASE_SHAPES]:
        A = spd_batch(b, pb, ALPHAS[0], seed=pb)
        got = H.chol_inv_panel(A)
        ref = H.chol_inv_panel_plain(A)
        torch.cuda.synchronize()
        max_abs = float((got - ref).abs().max())
        max_rel = max_abs / float(ref.abs().max())
        if not (max_rel <= KERNEL_TOL):
            raise AssertionError(f"chol_inv_panel PB={pb}: max rel err {max_rel:.3e} "
                                 f"> {KERNEL_TOL:g}")
        eye = torch.eye(pb, device=DEVICE).expand(A.shape)

        def library():
            L, _ = torch.linalg.cholesky_ex(A)
            return torch.linalg.solve_triangular(L, eye, upper=False)

        # 25 samples of 20 calls each, after 100 calls of warm-up
        ms = cuda_time_ms(lambda: H.chol_inv_panel(A), warmup=100, per_sample=20)
        plain_ms = cuda_time_ms(lambda: H.chol_inv_panel_plain(A), warmup=100, per_sample=20)
        library_ms = cuda_time_ms(library, warmup=100, per_sample=20)
        # chol(A) depends on A's lower triangle only; the full L^-1 is written
        bytes_moved = b * (pb * (pb + 1) // 2 + pb * pb) * 4
        flops = 2.0 / 3.0 * pb ** 3 * b
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / FP32_FLOP_PER_S * 1e3
        shapes.append({
            "shape": [b, pb, pb], "max_abs_err": max_abs, "max_rel_err": max_rel,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_ratio": ms / library_ms, "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        })
    return shapes


def streamed_inputs(name: str, kind: str, seed: int) -> tuple:
    """Main-path-shaped inputs of a streamed scorer, on the card.

    The fold patches come as the main path hands them over, a transposed
    view [B, nv, K] of [nv, B, K], and U and Z as views of buffers with
    padded rows (``HM.padded_empty``).  Integer-valued inputs (in -3..3) keep
    every product exact in float32 (|sim| < 2^24), and latent rows of
    sixteen +-1 entries have norm exactly 4, so the plain version's counts
    are exact and must be met exactly.
    """
    import torch

    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM

    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def draw(*shape):
        if kind == "integer":
            return torch.randint(-3, 4, shape, generator=gen, device=DEVICE).float()
        return torch.randn(shape, generator=gen, device=DEVICE)

    def draw_k_by_nv():
        return HM.padded_empty(B, K, NV, DEVICE).copy_(draw(B, K, NV))

    if name == "streamed_pairwise_acc":
        if kind == "integer":
            top = torch.rand((NV, D), generator=gen, device=DEVICE).topk(16, dim=-1).indices
            signs = torch.randint(0, 2, top.shape, generator=gen, device=DEVICE).float() * 2 - 1
            latents = torch.zeros((NV, D), device=DEVICE).scatter_(1, top, signs)
        else:
            latents = draw(NV, D)
        return draw(B, NV, D), latents
    Xv_b = draw(NV, B, K).permute(1, 0, 2)
    if name == "streamed_acc_from_inv":
        return Xv_b, draw(B, K, K), draw_k_by_nv()
    return Xv_b, draw_k_by_nv()


def kernel_streamed(name: str) -> dict:
    """One streamed-count kernel at the main path's shape against its plain version."""
    import torch

    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM

    kernel, plain = getattr(HM, name), getattr(HM, name + "_plain")
    args = streamed_inputs(name, "integer", seed=11)
    got, ref = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"{name}: integer inputs, counts differ from the plain version "
                             f"at {int((got != ref).sum())} of {B} vertices")
    del args, got, ref
    args = streamed_inputs(name, "gaussian", seed=12)
    got, ref = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    max_abs = float((got - ref).abs().max())
    if not (max_abs <= ACC_TOL):
        raise AssertionError(f"{name}: Gaussian inputs, max |acc - plain| {max_abs:.3e} "
                             f"> {ACC_TOL:g}")

    # the same product by cuBLAS, without the count: what the GEMM alone costs
    if name == "streamed_pairwise_acc":
        preds, latents = args
        y_t = (latents / torch.linalg.vector_norm(latents, dim=-1, keepdim=True)).mT

        def library():
            return torch.matmul(preds, y_t)
    elif name == "streamed_acc_from_inv":
        Xv_b, inv, U = args

        def library():
            return torch.bmm(Xv_b, torch.bmm(inv, U))
    else:
        Xv_b, Z = args

        def library():
            return torch.bmm(Xv_b, Z)

    ms = cuda_time_ms(lambda: kernel(*args), reps=10, warmup=2)
    plain_ms = cuda_time_ms(lambda: plain(*args), reps=10, warmup=2)
    library_ms = cuda_time_ms(library, reps=10, warmup=2)
    parts = {}
    if name == "streamed_acc_from_inv":  # its Z GEMM and its count, each beside cuBLAS
        Z = HM.inv_times_u_on_card(inv, U)
        parts = {
            "z_gemm_ms": cuda_time_ms(lambda: HM.inv_times_u_on_card(inv, U), reps=10, warmup=2),
            "z_gemm_library_ms": cuda_time_ms(lambda: torch.bmm(inv, U), reps=10, warmup=2),
            "count_ms": cuda_time_ms(lambda: HM.streamed_acc_from_factors(Xv_b, Z),
                                     reps=10, warmup=2),
            "count_library_ms": cuda_time_ms(lambda: torch.bmm(Xv_b, Z), reps=10, warmup=2),
        }
        parts["z_gemm_library_ratio"] = parts["z_gemm_ms"] / parts["z_gemm_library_ms"]
        parts["count_library_ratio"] = parts["count_ms"] / parts["count_library_ms"]
        del Z
    # each input read once, the [B] accuracies written once
    depth = D if name == "streamed_pairwise_acc" else K
    flops = 2.0 * B * NV * NV * depth
    n_in = sum(a.numel() for a in args)
    if name == "streamed_acc_from_inv":
        flops += 2.0 * B * K * K * NV
    bytes_ms = (n_in + B) * 4 / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP32_FLOP_PER_S * 1e3
    return {"shape": [list(a.shape) for a in args], "max_abs_err": max_abs,
            "integer_counts_equal": True, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_ratio": ms / library_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "flops": flops, "tflops_per_s": flops / (ms * 1e-3) / 1e12, **parts}


def planted_problem(coords, seed: int):
    """Full-width block inputs with a planted linear signal, made on the card.

    The signal's scale rises from 1e-3 at the sphere's south pole to 2e-2 at
    its north pole, so neighbourhoods span weak to saturated decoding and the
    CV-selected alphas spread over the grid instead of all landing on one edge.
    """
    import torch

    z = torch.as_tensor(coords[:, 2] / (coords ** 2).sum(1) ** 0.5, dtype=torch.float32,
                        device=DEVICE)
    scale = 10.0 ** (-3.0 + 1.3 * (z + 1) / 2)  # [V]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    Y_train = torch.randn((N_TRAIN, D), generator=gen, device=DEVICE)
    Y_test = torch.randn((N_TEST, D), generator=gen, device=DEVICE)
    Y_imag = torch.randn((N_IMAG, D), generator=gen, device=DEVICE)
    W_true = torch.randn((D, len(coords)), generator=gen, device=DEVICE) * scale
    noise = torch.randn((N_TRAIN + N_TEST + N_IMAG, len(coords)), generator=gen,
                        device=DEVICE)
    X_all = noise + torch.cat([Y_train, Y_test, Y_imag]) @ W_true
    X_all = X_all.cpu().numpy()
    return (X_all[:N_TRAIN], X_all[N_TRAIN:N_TRAIN + N_TEST], X_all[N_TRAIN + N_TEST:],
            Y_train.cpu().numpy(), Y_test.cpu().numpy(), Y_imag.cpu().numpy())


class GateProblem:
    """The selection gate's problem: two full-width blocks of a planted signal
    graded over the sphere, with the null shuffles of a real run."""

    def __init__(self):
        import numpy as np

        from multimodal_decoding_tpu_torch.data.stimuli import (
            create_null_distr_shuffled_indices,
        )
        from multimodal_decoding_tpu_torch.io.surface import icosphere, knn_adjacency

        coords = icosphere(4).coordinates
        self.adjacency = knn_adjacency(coords, K)[0][:2 * B]
        self.problem = planted_problem(coords, seed=0)
        self.shuffles = np.stack(create_null_distr_shuffled_indices(P)).astype(np.int32)
        self.stim_types = np.array(["caption"] * (N_TEST // 2) + ["image"] * (N_TEST // 2))

    def run(self, solver, scorer, mesh=None, **kw):
        """The runner over both blocks, on one device or a "v" mesh: (scores,
        aux).  ``kw``: more run_searchlight arguments (cv_precision, ...)."""
        from multimodal_decoding_tpu_torch.parallel.searchlight_runner import run_searchlight

        return run_searchlight(*self.problem, self.adjacency, self.stim_types,
                               alphas_cv=ALPHAS, shuffles=self.shuffles, block_size=B,
                               mesh=mesh, device=None if mesh else DEVICE, cv_solver=solver,
                               cv_scorer=scorer, progress=False, **kw)

    def cv_grids(self, runs, **kw):
        """Per block, the CV-score grids [B, A] of fit_block_cv for each
        (name, cv_solver, cv_scorer) in ``runs``: {name: [grid, grid]}.
        ``kw``: more fit_block_cv arguments (cv_precision, cv_dtype)."""
        import torch

        from multimodal_decoding_tpu_torch.decoding import searchlight_engine as E

        X_train = torch.as_tensor(self.problem[0], device=DEVICE)
        Y_train = torch.as_tensor(self.problem[3], device=DEVICE)
        alphas = torch.as_tensor(ALPHAS, dtype=torch.float32, device=DEVICE)
        grids = {name: [] for name, _, _ in runs}
        for b in range(2):
            idx = torch.as_tensor(self.adjacency[b * B:(b + 1) * B], device=DEVICE)
            Xg = E.gather_patches(X_train, idx)
            for name, solver, scorer in runs:
                grids[name].append(E.fit_block_cv(Xg, Y_train, alphas, cv_solver=solver,
                                                   cv_scorer=scorer, **kw)[2])
            del Xg
        return grids


def compare_paths(got, got_aux, ref, ref_aux) -> dict:
    """Alpha agreement, final- and null-score deltas of two runner results."""
    import numpy as np

    return {
        "alpha_agreement": float(np.mean(got_aux["best_alpha"] == ref_aux["best_alpha"])),
        "max_final_score_delta": max(float(np.max(np.abs(got[m] - ref[m]))) for m in ref),
        "max_null_score_delta": max(
            float(np.max(np.abs(got_aux["null_scores"][m] - ref_aux["null_scores"][m])))
            for m in ref_aux["null_scores"]),
    }


def phase_gate() -> dict:
    import numpy as np

    from multimodal_decoding_tpu_torch.decoding.searchlight import default_cv_solver
    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H

    cv_solver = default_cv_solver(DEVICE)
    if cv_solver != "schur-pallas":
        raise AssertionError(f"CUDA default CV solver is {cv_solver!r}, not 'schur-pallas'")
    gate = GateProblem()
    H.reset_launches()
    HM.reset_launches()
    fast, fast_aux = gate.run(cv_solver, "xla")
    launches = H.launches
    streamed_launches = sum(HM.launches.values())
    strict, strict_aux = gate.run(None, "strict")
    cmp = compare_paths(fast, fast_aux, strict, strict_aux)
    agreement, delta = cmp["alpha_agreement"], cmp["max_final_score_delta"]
    null_delta = cmp["max_null_score_delta"]

    # the CV score grids themselves: the scale-invariant and cosine scorers
    # rank identically, so the two selection paths differ only by rounding
    grids = gate.cv_grids([("fast", cv_solver, "xla"), ("strict", None, "strict")])
    cv_delta = max(float((f - s).abs().max()) for f, s in zip(grids["fast"], grids["strict"]))

    counts = dict(zip(*np.unique(fast_aux["best_alpha"], return_counts=True)))
    out = {"cv_solver": cv_solver, "alpha_agreement": agreement,
           "best_alpha_counts": {f"{a:g}": int(c) for a, c in counts.items()},
           "max_cv_score_delta": cv_delta,
           "max_final_score_delta": delta, "max_null_score_delta": null_delta,
           "launches": launches, "expected_launches": 2 * LAUNCHES_PER_BLOCK,
           "fast_vertices_per_sec": fast_aux["vertices_per_sec"],
           "strict_vertices_per_sec": strict_aux["vertices_per_sec"]}
    if len(counts) < MIN_DISTINCT_ALPHAS:
        raise AssertionError(f"only {len(counts)} distinct alphas selected: the planted "
                             f"signal does not exercise the selection: {out}")
    if agreement < ALPHA_AGREEMENT_MIN:
        raise AssertionError(f"alpha agreement {agreement:.4f} < {ALPHA_AGREEMENT_MIN}: {out}")
    if cv_delta > CV_SCORE_DELTA_MAX:
        raise AssertionError(f"CV-score delta {cv_delta:.3e} > {CV_SCORE_DELTA_MAX}: {out}")
    if delta > SCORE_DELTA_MAX:
        raise AssertionError(f"final-score delta {delta:.3e} > {SCORE_DELTA_MAX}: {out}")
    if launches != 2 * LAUNCHES_PER_BLOCK:
        raise AssertionError(f"{launches} kernel launches, expected "
                             f"{2 * LAUNCHES_PER_BLOCK}: {out}")
    if streamed_launches:
        raise AssertionError(f"the xla scorer launched {streamed_launches} streamed kernels")
    return out


def phase_scorers() -> dict:
    """The streamed-count selection path, each scorer held to the strict path."""
    import numpy as np

    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H

    gate = GateProblem()
    strict, strict_aux = gate.run(None, "strict")
    out = {"strict_vertices_per_sec": strict_aux["vertices_per_sec"]}
    for scorer in ("xla", *STREAMED_SCORERS):
        H.reset_launches()
        HM.reset_launches()
        got, got_aux = gate.run("schur-pallas", scorer)
        launches = {"chol_inv_panel": H.launches, **HM.launches}
        counts = dict(zip(*np.unique(got_aux["best_alpha"], return_counts=True)))
        out[scorer] = {**compare_paths(got, got_aux, strict, strict_aux),
                       "best_alpha_counts": {f"{a:g}": int(c) for a, c in counts.items()},
                       "launches": launches,
                       "vertices_per_sec": got_aux["vertices_per_sec"]}
    grids = gate.cv_grids([("strict", None, "strict")]
                          + [(s, "schur-pallas", s) for s in ("xla", *STREAMED_SCORERS)])
    for scorer in ("xla", *STREAMED_SCORERS):
        res = out[scorer]
        res["max_cv_score_delta"] = max(float((g - s).abs().max())
                                        for g, s in zip(grids[scorer], grids["strict"]))
        limit = (FUSED_CV_SCORE_DELTA_MAX if scorer.startswith("fused")
                 else CV_SCORE_DELTA_MAX)
        expected = {"chol_inv_panel": 2 * LAUNCHES_PER_BLOCK, **dict.fromkeys(HM.KERNELS, 0)}
        if STREAMED_SCORERS.get(scorer):
            expected[STREAMED_SCORERS[scorer]] = 2 * SCORER_CALLS_PER_BLOCK
        fails = []
        if len(res["best_alpha_counts"]) < MIN_DISTINCT_ALPHAS:
            fails.append(f"only {len(res['best_alpha_counts'])} distinct alphas")
        if res["alpha_agreement"] < ALPHA_AGREEMENT_MIN:
            fails.append(f"alpha agreement {res['alpha_agreement']:.4f} < {ALPHA_AGREEMENT_MIN}")
        if res["max_cv_score_delta"] > limit:
            fails.append(f"CV-score delta {res['max_cv_score_delta']:.3e} > {limit:g}")
        if res["max_final_score_delta"] > SCORE_DELTA_MAX:
            fails.append(f"final-score delta {res['max_final_score_delta']:.3e} "
                         f"> {SCORE_DELTA_MAX:g}")
        if res["launches"] != expected:
            fails.append(f"launches {res['launches']}, expected {expected}")
        if fails:
            raise AssertionError(f"cv_scorer {scorer!r}: {'; '.join(fails)}: {res}")
    return out


def device_rows(prof) -> list:
    """(name, device us, calls) of a profile's device-side rows (kernels and
    copies; operator rows repeat their time), longest first."""
    import torch

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    return sorted(((e.key, dev_us(e), e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0),
                  key=lambda r: -r[1])


def profiled(fn) -> dict:
    """Wall ms, device ms, busy share and top device rows of one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    rows = device_rows(prof)
    device_ms = sum(r[1] for r in rows) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
            "top": [{"name": k[:90], "ms": us / 1e3, "calls": c} for k, us, c in rows[:10]]}


def phase_wb_profile() -> dict:
    """Where the whole-brain stages' time goes: the streamed gram over 8
    column blocks of host betas, one fast and one strict CV at N=8192."""
    import numpy as np
    import torch

    from multimodal_decoding_tpu_torch.ops.ridge import ridge_cv_dual, streamed_kernels

    rng = np.random.default_rng(0)
    X = rng.standard_normal((N_TRAIN, 8 * 16384), dtype=np.float32)
    Xq = rng.standard_normal((N_TEST + N_IMAG, 8 * 16384), dtype=np.float32)
    streamed_kernels(X[:, :16384], (Xq[:, :16384],), device=DEVICE)  # warm-up
    out = {"gram_8_blocks": profiled(lambda: streamed_kernels(X, (Xq,), device=DEVICE))}
    # the host side alone: the 8 train blocks copied into one pinned buffer
    pinned = torch.empty((N_TRAIN, 16384), dtype=torch.float32, pin_memory=True)
    host = torch.from_numpy(X)
    t0 = time.time()
    for lo in range(0, X.shape[1], 16384):
        pinned.copy_(host[:, lo:lo + 16384])
    out["host_copy_gb_per_s"] = X.nbytes / (time.time() - t0) / 1e9
    out["host_threads"] = torch.get_num_threads()
    K, _, Y = wb_gate_problem(0, 4.0)
    for name, solver in (("cv_fast", "schur-pallas"), ("cv_strict", None)):
        ridge_cv_dual(K, Y[:N_TRAIN], ALPHAS, cv_solver=solver, device=DEVICE)  # warm-up
        out[name] = profiled(lambda: ridge_cv_dual(K, Y[:N_TRAIN], ALPHAS, cv_solver=solver,
                                                   device=DEVICE))
    return out


def phase_profile(scorer: str = "xla", precision: str = "highest") -> dict:
    """Where one main-path block step's device time goes (torch.profiler),
    with the CV fold scorer ``scorer`` at ``precision`` (``"default"`` and
    ``"high"`` with bf16 selection storage, as phase precision runs them)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multimodal_decoding_tpu_torch.data.stimuli import create_null_distr_shuffled_indices
    from multimodal_decoding_tpu_torch.decoding import searchlight_engine as E
    from multimodal_decoding_tpu_torch.io.surface import icosphere, knn_adjacency

    coords = icosphere(4).coordinates
    idx = torch.as_tensor(knn_adjacency(coords, K)[0][:B], device=DEVICE)
    Xtr, Xte, Xim, Ytr, Yte, Yim = planted_problem(coords, seed=1)
    X_all = torch.as_tensor(np.concatenate([Xtr, Xte, Xim]), device=DEVICE)
    Ytr, Yte, Yim = (torch.as_tensor(a, device=DEVICE) for a in (Ytr, Yte, Yim))
    shuffles = torch.as_tensor(np.stack(create_null_distr_shuffled_indices(P)), device=DEVICE)
    der = torch.as_tensor(np.random.default_rng(0).integers(0, 2, (B, P)), device=DEVICE)
    alphas = torch.as_tensor(ALPHAS, dtype=torch.float32, device=DEVICE)
    layout = E.TestLayout.from_stim_types(["caption"] * (N_TEST // 2) + ["image"] * (N_TEST // 2))

    reduced = {} if precision == "highest" else {"cv_precision": precision,
                                                 "cv_dtype": torch.bfloat16}

    def step():
        return E.searchlight_block_cv_with_null(
            X_all, Ytr, Yte, Yim, idx, None, alphas, shuffles, der, layout=layout,
            n_train=N_TRAIN, n_test=N_TEST, cv_solver="schur-pallas", cv_scorer=scorer,
            **reduced)

    step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.time()
        step()
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step()
        torch.cuda.synchronize()
        prof_wall = time.time() - t0

    kernels = device_rows(prof)
    device_ms = sum(r[1] for r in kernels) / 1e3
    # the port's hand-written kernels, wherever they rank
    port = [{"name": k[:90], "ms": us / 1e3, "calls": c} for k, us, c in kernels
            if any(n in k for n in ("chol_inv_panel_kernel", "tile_kernel", "tc_kernel",
                                    "split_bf16"))]
    return {"cv_scorer": scorer, "cv_precision": precision,
            "block_wall_ms": sorted(walls)[1] * 1e3, "profiled_wall_ms": prof_wall * 1e3,
            "device_ms": device_ms, "device_busy_share": device_ms / (prof_wall * 1e3),
            "top": [{"name": k[:90], "ms": us / 1e3, "calls": c} for k, us, c in kernels[:14]],
            "port_kernels": port}


def cli_dataset(root: str) -> dict:
    """Phase cli's synthetic subject under ``root``: N_TRAIN train stimuli,
    D-wide latents, the left hemisphere of icosphere(4) (radius 100) as the
    fsaverage7 inflated mesh.  Returns make_synthetic_dataset's info with
    ``root``, ``mesh`` and ``dataset_s``; use_dataset points the config at it."""
    from multimodal_decoding_tpu_torch.data.synthetic import make_synthetic_dataset
    from multimodal_decoding_tpu_torch.io.surface import icosphere, write_freesurfer_geometry

    t0 = time.time()
    mesh = icosphere(4)
    info = make_synthetic_dataset(root, n_train=N_TRAIN, n_vertices=mesh.n_vertices,
                                  latent_dim=D, model="imagebind", hemis=["left"])
    mesh_dir = os.path.join(root, "surfaces", "fsaverage7")
    os.makedirs(mesh_dir)
    write_freesurfer_geometry(os.path.join(mesh_dir, "lh.inflated"), mesh)
    return {**info, "root": root, "mesh": mesh, "dataset_s": time.time() - t0}


def use_dataset(info: dict) -> None:
    """Point the port's config at a data set of cli_dataset."""
    from multimodal_decoding_tpu_torch import config
    from multimodal_decoding_tpu_torch.data.features import _load_feature_pickle

    config.FMRI_STIM_INFO_DIR = info["stim_info_dir"]
    config.LATENT_FEATURES_DIR = info["features_dir"]
    config.BETAS_CACHE_DIR = os.path.join(info["root"], "betas_cache")
    _load_feature_pickle.cache_clear()


def searchlight_argv(info: dict, out_dir: str, *mode) -> list:
    """The searchlight CLI's arguments on a cli_dataset at full width, with
    ``mode`` (--n-neighbors K or --radius r)."""
    return ["--betas-dir", os.path.join(info["betas_dir"], "surface"),
            "--subjects", "sub-01", "--model", "imagebind", "--hemis", "left",
            *mode, "--l2-alphas", *[str(a) for a in ALPHAS],
            "--create-null-distr", "--n-permutations-per-subject", str(P),
            "--block-size", str(B), "--mesh-dir", os.path.join(info["root"], "surfaces"),
            "--out-dir", out_dir, "--device", DEVICE]


def phase_cli() -> dict:
    import numpy as np
    import torch

    from multimodal_decoding_tpu_torch.cli import run_searchlight as cli
    from multimodal_decoding_tpu_torch.io import artifacts
    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H
    from multimodal_decoding_tpu_torch.ops import metrics as M

    root = WS.dir("cli")  # kept for phases radius and precision (--fast-math)
    info = cli_dataset(root)
    use_dataset(info)
    dataset_s = info["dataset_s"]

    out_dir = os.path.join(root, "sl")
    argv = searchlight_argv(info, out_dir, "--n-neighbors", str(K))
    H.reset_launches()
    HM.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.time()
    paths = cli.main(argv)
    cli_s = time.time() - t1
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = H.launches
    if any(HM.launches.values()):
        raise AssertionError(f"the default path launched streamed kernels: {HM.launches}")

    if len(paths) != 1:
        raise AssertionError(f"expected one results pickle, got {paths}")
    res = artifacts.load_pickle(paths[0])
    null = artifacts.load_null_scores_npz(
        os.path.join(os.path.dirname(paths[0]), "null_distr.npz"))
    n_vert = int((~res["nan_locations"]).sum())
    for m, v in res["score_maps"].items():
        if v.shape != (n_vert,) or not np.all(np.isfinite(v)):
            raise AssertionError(f"score map {m}: shape {v.shape}, finite "
                                 f"{bool(np.all(np.isfinite(v)))}")
    for m, v in null.items():
        if v.shape != (n_vert, P) or not np.all(np.isfinite(v)):
            raise AssertionError(f"null scores {m}: shape {v.shape}")
    means = {m: float(np.mean(res["score_maps"][m])) for m in (M.ACC_CAPTIONS, M.ACC_IMAGES)}
    if min(means.values()) <= 0.9:
        raise AssertionError(f"planted-signal accuracies too low: {means}")
    expected = -(-n_vert // B) * LAUNCHES_PER_BLOCK
    if launches != expected:
        raise AssertionError(f"{launches} kernel launches in the CLI run, "
                             f"expected {expected}")
    WS.runs["cli"] = {"argv": argv, "info": info, "results": paths[0], "cli_s": cli_s,
                      "peak_gb": peak_gb, "launches": launches}
    return {"vertices": n_vert, "vertices_per_sec": res["vertices_per_sec"],
            "device_peak_gb": peak_gb,
            "searchlight_s": res["elapsed_s"], "cli_s": cli_s,
            "dataset_s": dataset_s, "mean_acc": means,
            "best_alpha_counts": {str(a): int(c) for a, c in
                                  zip(*np.unique(res["best_alpha"], return_counts=True))},
            "launches": launches}


def radius_for(coords, kmean: int) -> float:
    """The ball radius (to 0.01) whose balls hold ~``kmean`` of ``coords`` on
    average: the uniform-sphere estimate 2 R sqrt(kmean / V) (a ball of chord
    radius r on a sphere of radius R holds the share r^2 / 4R^2 of its
    area), corrected once by exact host counts on RD_SAMPLE vertices."""
    import numpy as np
    from scipy.spatial import cKDTree

    pts = np.asarray(coords, dtype=np.float64)
    r = 2.0 * float(np.sqrt((pts ** 2).sum(1)).mean()) * (kmean / len(pts)) ** 0.5
    rng = np.random.default_rng(0)
    sample = pts[rng.choice(len(pts), min(RD_SAMPLE, len(pts)), replace=False)]
    n = cKDTree(pts).query_ball_point(sample, r, return_length=True, workers=-1).mean()
    return round(r * (kmean / n) ** 0.5, 2)


def radius_count_flips(coords, r: float, idx, mask, counts) -> dict:
    """The card's radius counts (float32 |q|^2 - 2 q.p + |p|^2 <= r^2) against
    float64 host counts (scipy's cKDTree on the same float32 coordinates).
    Every neighbour that one side has and the other lacks must lie within
    RD_FLIP_ULPS float32 roundings of the terms' magnitude from r^2."""
    import numpy as np
    from scipy.spatial import cKDTree

    pts = np.asarray(coords, dtype=np.float32).astype(np.float64)
    tree = cKDTree(pts)
    t0 = time.time()
    host = tree.query_ball_point(pts, r, return_length=True, workers=-1)
    host_s = time.time() - t0
    differ = np.nonzero(host != counts)[0]
    norms = np.sqrt((pts ** 2).sum(1))
    eps = float(np.finfo(np.float32).eps)
    gaps, worst = [], 0.0
    for v in differ:
        card = set(idx[v][mask[v]].tolist())
        for p in card.symmetric_difference(tree.query_ball_point(pts[v], r)):
            gap = abs(float(((pts[v] - pts[p]) ** 2).sum()) - r * r)
            tol = RD_FLIP_ULPS * eps * (norms[v] + norms[p]) ** 2
            gaps.append(gap)
            worst = max(worst, gap / tol)
    out = {"host_count_s": host_s, "vertices_differing": int(len(differ)),
           "neighbours_flipped": len(gaps),
           "max_abs_d2_minus_r2": max(gaps, default=0.0),
           "max_gap_over_float32_tolerance": worst}
    if worst > 1.0:
        raise AssertionError(f"radius counts: a neighbour flips farther from r^2 than float32 "
                             f"rounding explains: {out}")
    return out


class RadiusProblem:
    """Block inputs on the card over a compact set of columns, and the
    reference of the JAX package's test_radius_mask_equals_column_drop: the
    same block step on each count's vertices with the pad columns dropped."""

    def __init__(self, X_all, Y_train, Y_test, Y_imag):
        import numpy as np
        import torch

        from multimodal_decoding_tpu_torch.data.stimuli import (
            TEST_STIM_TYPES,
            create_null_distr_shuffled_indices,
        )
        from multimodal_decoding_tpu_torch.decoding import searchlight_engine as E

        def dev(a, dtype=torch.float32):  # as run_searchlight places its inputs
            return torch.as_tensor(np.asarray(a), device=DEVICE).to(dtype)

        self.X_all, self.Ytr, self.Yte, self.Yim = (dev(a) for a in (X_all, Y_train, Y_test,
                                                                     Y_imag))
        self.alphas = dev(ALPHAS)
        self.shuffles = dev(np.stack(create_null_distr_shuffled_indices(P)), torch.int64)
        self.stim_types = TEST_STIM_TYPES
        self.layout = E.TestLayout.from_stim_types(TEST_STIM_TYPES)

    def block(self, idx, mask, der, shuffles=None, **kw) -> tuple:
        """searchlight_block_cv_with_null on the card: (main, null) as numpy."""
        import torch

        from multimodal_decoding_tpu_torch.decoding import searchlight_engine as E

        main, null = E.searchlight_block_cv_with_null(
            self.X_all, self.Ytr, self.Yte, self.Yim, torch.as_tensor(idx, device=DEVICE),
            None if mask is None else torch.as_tensor(mask, device=DEVICE), self.alphas,
            self.shuffles if shuffles is None else shuffles,
            torch.as_tensor(der, device=DEVICE), layout=self.layout, n_train=N_TRAIN,
            n_test=N_TEST, cv_solver="schur-pallas", **kw)
        return ({k: v.cpu().numpy() for k, v in main.items()},
                {k: v.cpu().numpy() for k, v in null.items()})

    def cv_grid(self, idx, mask):
        """fit_block_cv's CV scores [V, A] (the selection's grid) on the card."""
        import torch

        from multimodal_decoding_tpu_torch.decoding import searchlight_engine as E

        Xtr = E.gather_patches(self.X_all[:N_TRAIN], torch.as_tensor(idx, device=DEVICE),
                               None if mask is None else torch.as_tensor(mask, device=DEVICE))
        return E.fit_block_cv(Xtr, self.Ytr, self.alphas, cv_solver="schur-pallas")[2].cpu().numpy()

    def column_drop(self, idx, counts, der) -> tuple:
        """The block step, and the CV grid, with each vertex's first
        ``counts`` neighbours only, one call per count: (main, null, grid) in
        the rows of ``idx``."""
        import numpy as np

        main, null, grid = {}, {}, np.empty((len(idx), len(ALPHAS)), np.float32)
        for c in np.unique(counts):
            rows = np.nonzero(counts == c)[0]
            m, n = self.block(idx[rows, :c], None, der[rows])
            grid[rows] = self.cv_grid(idx[rows, :c], None)
            for out, got in ((main, m), (null, n)):
                for k, v in got.items():
                    out.setdefault(k, np.empty((len(idx),) + v.shape[1:], v.dtype))[rows] = v
        return main, null, grid

    def near_tie_gaps(self, idx, counts, alphas) -> dict:
        """{metric: [V]}: each vertex's least float64 gap between two
        distances that metric's rank counts compare (all pairs of a row of
        its distance matrix), at the vertex's selected alpha."""
        import numpy as np
        import torch

        from multimodal_decoding_tpu_torch.ops import metrics as M

        cap = torch.as_tensor(self.stim_types == "caption", device=DEVICE)
        Y = [t.double() for t in (self.Ytr, self.Yte, self.Yim)]
        whole = torch.cat([Y[2], Y[1]])

        def std(x):
            s = x.std(dim=-2, unbiased=False, keepdim=True)
            return (x - x.mean(dim=-2, keepdim=True)) / torch.where(s == 0, 1.0, s)

        def gap(p, l):
            d = 1 - (p / p.norm(dim=-1, keepdim=True)) @ (l / l.norm(dim=-1, keepdim=True)).T
            g = (d[:, :, None] - d[:, None, :]).abs()
            g.diagonal(dim1=-2, dim2=-1).fill_(float("inf"))
            return float(g.min())

        gaps = {}
        for nb, c, a in zip(idx, counts, alphas):
            cols = torch.as_tensor(nb[:c], device=DEVICE)
            X = self.X_all[:, cols].double()
            A = X[:N_TRAIN]
            W = torch.linalg.solve(A.T @ A + float(a) * torch.eye(int(c), dtype=A.dtype,
                                                                  device=DEVICE), A.T @ Y[0])
            pt, pi = X[N_TRAIN:N_TRAIN + N_TEST] @ W, X[N_TRAIN + N_TEST:] @ W
            pc, pm = std(pt[cap]), std(pt[~cap])
            for m, g in ((M.ACC_CAPTIONS, gap(pc, Y[1][cap])), (M.ACC_IMAGES, gap(pm, Y[1][~cap])),
                         (M.ACC_CROSS_CAPTIONS_TO_IMAGES, gap(pc, Y[1][~cap])),
                         (M.ACC_CROSS_IMAGES_TO_CAPTIONS, gap(pm, Y[1][cap])),
                         (M.ACC_IMAGERY, gap(std(pi), Y[2])),
                         (M.ACC_IMAGERY_WHOLE_TEST, gap(std(pi), whole)),
                         (M.ACC_IMAGERY + "_no_std", gap(pi, Y[2])),
                         (M.ACC_IMAGERY_WHOLE_TEST + "_no_std", gap(pi, whole))):
                gaps.setdefault(m, []).append(g)
        return {m: np.asarray(v) for m, v in gaps.items()}

    def hold_to_column_drop(self, main, null, idx, counts, der, where: str) -> dict:
        """``main``/``null`` of masked blocks against column_drop.

        The CV grids agree within CV_SCORE_DELTA_MAX (the gate's bar).  The
        alphas are equal but at a selection near-tie: a vertex may pick
        another alpha only where, the column drop's grid moved by twice that
        vertex's grid delta, the masked pick is the first within
        ALPHA_TIE_TOL of the top.  At every vertex whose alphas agree, each
        metric's final scores are within SCORE_DELTA_MAX and its nulls equal
        unless its rank counts compare two float64 distances closer than
        RD_TIE_GAP (gap 0: duplicate latent rows, as imagery and test
        stimuli share some): there two float32 sums may order the pair
        differently, which moves the accuracy by a count (1/4830 for
        captions, 1/6 for imagery).  The excused vertices' gaps are printed.
        """
        import numpy as np

        from multimodal_decoding_tpu_torch.ops.ridge import ALPHA_TIE_TOL

        ref_main, ref_null, ref_grid = self.column_drop(idx, counts, der)
        real = np.arange(idx.shape[1])[None, :] < counts[:, None]
        grid = np.concatenate([self.cv_grid(idx[lo:lo + B], real[lo:lo + B])
                               for lo in range(0, len(idx), B)])
        grid_delta = np.abs(grid - ref_grid).max(axis=1)  # [V]
        picked = np.searchsorted(np.asarray(ALPHAS, np.float32), main["best_alpha"])
        top = ref_grid.max(axis=1)
        slack = ALPHA_TIE_TOL + 2 * grid_delta
        near_tie_pick = ((ref_grid[np.arange(len(idx)), picked] >= top - slack)
                         & np.array([np.all(g[:a] < t - ALPHA_TIE_TOL + 2 * e)
                                     for g, a, t, e in zip(ref_grid, picked, top, grid_delta)]))
        same = main["best_alpha"] == ref_main["best_alpha"]
        differ = {m: same & (np.abs(main[m] - v) > SCORE_DELTA_MAX)
                  for m, v in ref_main.items() if m != "best_alpha"}
        for m, v in ref_null.items():
            differ[m] = differ.get(m, False) | (same & (null[m] != v).any(axis=1))
        rows = np.nonzero(np.any(list(differ.values()), axis=0))[0]
        gaps = self.near_tie_gaps(idx[rows], counts[rows], ref_main["best_alpha"][rows])
        excused = [float(gaps[m][i]) for m, d in differ.items()
                   for i, v in enumerate(rows) if d[v]]
        out = {"vertices": len(idx), "alpha_agreement": float(same.mean()),
               "max_cv_score_delta": float(grid_delta.max()),
               "other_alpha_at_a_selection_near_tie": int((~same & near_tie_pick).sum()),
               "max_final_score_delta": max(float(np.abs(main[m] - v)[same].max(initial=0.0))
                                            for m, v in ref_main.items() if m != "best_alpha"),
               "max_null_score_delta": max(float(np.abs(null[m] - v)[same].max(initial=0.0))
                                           for m, v in ref_null.items()),
               "vertices_differing": len(rows),
               "differing_by_metric": {m: int(d.sum()) for m, d in differ.items() if d.any()},
               "their_float64_gaps": [min(excused, default=None), max(excused, default=None)]}
        fails = []
        if out["max_cv_score_delta"] > CV_SCORE_DELTA_MAX:
            fails.append(f"CV-score delta > {CV_SCORE_DELTA_MAX:g}")
        if np.any(~same & ~near_tie_pick):
            fails.append("an alpha differs where the selection holds no near-tie")
        if any(g >= RD_TIE_GAP for g in excused):
            fails.append(f"a score (final delta > {SCORE_DELTA_MAX:g}, or null) differs at a "
                         f"vertex whose metric holds no near-tie (< {RD_TIE_GAP:g})")
        if fails:
            raise AssertionError(f"{where} against the column drop: {'; '.join(fails)}: {out}")
        return out


def radius_patch(coords, idx, mask, counts) -> dict:
    """Two blocks of B vertices along the meridian x = 0, y > 0 from 80
    degrees south to 80 north, interleaved so each block spans every
    latitude (planted_problem grades the signal from pole to pole), their
    neighbourhoods and K-nearest ones over the union of the columns they
    read, renumbered into that union."""
    import numpy as np
    from scipy.spatial import cKDTree

    pts = np.asarray(coords, dtype=np.float64)
    tree = cKDTree(pts)
    # the 4B vertices nearest the meridian, then 2B of them evenly in z
    sin_lat = pts[:, 2] / np.sqrt((pts ** 2).sum(1))
    cand = np.nonzero((pts[:, 1] > 0) & (np.abs(sin_lat) < np.sin(np.radians(80.0))))[0]
    cand = cand[np.argsort(np.abs(pts[cand, 0]), kind="stable")[:4 * B]]
    cand = cand[np.argsort(pts[cand, 2], kind="stable")]
    sel = cand[np.linspace(0, len(cand) - 1, 2 * B).round().astype(int)]
    sel = np.concatenate([sel[0::2], sel[1::2]])
    knn = tree.query(pts[sel], k=K)[1]
    cols = np.unique(np.concatenate([idx[sel].ravel(), knn.ravel()]))
    return {"cols": cols, "idx": np.searchsorted(cols, idx[sel]).astype(np.int32),
            "mask": mask[sel], "counts": counts[sel],
            "knn": np.searchsorted(cols, knn).astype(np.int32)}


def radius_blocks(coords, idx, mask, counts) -> dict:
    """Two masked blocks of the fsaverage7-density adjacency through the main
    path's block step, held to the column drop; B1's launches and shapes;
    the null gathers held to each other; ms beside the n-neighbours block."""
    import numpy as np
    import torch

    from multimodal_decoding_tpu_torch.data.stimuli import create_null_distr_shuffled_indices
    from multimodal_decoding_tpu_torch.decoding import searchlight_engine as E
    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H
    from multimodal_decoding_tpu_torch.parallel.searchlight_runner import (
        draw_imagery_derangements,
    )

    patch = radius_patch(coords, idx, mask, counts)
    planted = planted_problem(np.asarray(coords)[patch["cols"]], seed=2)
    prob = RadiusProblem(np.concatenate(planted[:3]), *planted[3:])
    kmax = idx.shape[1]
    leaves = schur_base_blocks(kmax)
    blocks = [slice(b * B, (b + 1) * B) for b in range(2)]
    der = [draw_imagery_derangements(0, b, B, P) for b in range(2)]

    H.reset_launches()
    HM.reset_launches()
    with PanelCalls(keep_inputs=True) as calls:
        masked = [prob.block(patch["idx"][s], patch["mask"][s], d) for s, d in zip(blocks, der)]
        torch.cuda.synchronize()
    launches = H.launches
    if any(HM.launches.values()):
        raise AssertionError(f"the radius blocks launched streamed kernels: {HM.launches}")
    expected = 2 * SCORER_CALLS_PER_BLOCK * len(leaves)
    calls.check("radius blocks", shapes=[(B, pb) for pb in set(leaves)])
    if launches != expected:
        raise AssertionError(f"radius blocks: {launches} chol_inv_panel launches, expected "
                             f"{expected} (leaves {leaves} of Kmax {kmax})")
    # B1 on the path's own inputs (masked rows and columns: zero off the diagonal)
    held = {}
    for key, A in calls.inputs.items():
        got, ref = H.chol_inv_panel(A), H.chol_inv_panel_plain(A)
        rel = float((got - ref).abs().max() / ref.abs().max())
        off = A.abs().sum(-1) - A.diagonal(dim1=-2, dim2=-1).abs()
        held[key] = {"max_rel_err": rel, "masked_rows": int((off == 0).sum())}
        if not rel <= KERNEL_TOL:
            raise AssertionError(f"chol_inv_panel {key} on the radius path's input: max rel "
                                 f"err {rel:.3e} > {KERNEL_TOL:g}")

    out = {"kmax": kmax, "patch_columns": len(patch["cols"]),
           "counts": [int(patch["counts"].min()), int(patch["counts"].max())],
           "chol_inv_panel": {"launches": launches, "per_block": launches // 2,
                              "expected": expected, "shapes": calls.shapes,
                              "held_to_plain": held}}
    main = {k: np.concatenate([m[0][k] for m in masked]) for k in masked[0][0]}
    null = {k: np.concatenate([m[1][k] for m in masked]) for k in masked[0][1]}
    out["column_drop"] = prob.hold_to_column_drop(main, null, patch["idx"], patch["counts"],
                                                  np.concatenate(der), "radius blocks")
    alphas, n = np.unique(main["best_alpha"], return_counts=True)
    out["best_alpha_counts"] = {f"{a:g}": int(c) for a, c in zip(alphas, n)}

    # the null gathers: every block's nulls bit for bit; each mode's block ms
    gathers = {}
    for mode in E.NULL_GATHER_MODES:
        torch.cuda.synchronize()
        t0 = time.time()
        got = [prob.block(patch["idx"][s], patch["mask"][s], d, null_gather=mode)[1]
               for s, d in zip(blocks, der)]
        ms = (time.time() - t0) * 1e3 / len(blocks)
        delta = max(float(np.abs(g[k] - m[1][k]).max()) for g, m in zip(got, masked)
                    for k in g)
        gathers[mode] = {"max_abs_null_delta": delta, "block_ms": ms}
    # the null scoring alone on one block's predictions (CUDA events), at the
    # run's P and at the JAX package's measured P = 1000
    Xtr, Xte, Xim = E._split_patches(prob.X_all, torch.as_tensor(patch["idx"][blocks[0]],
                                                                 device=DEVICE),
                                     torch.as_tensor(patch["mask"][blocks[0]], device=DEVICE),
                                     N_TRAIN, N_TEST)
    W = E.fit_block_cv(Xtr, prob.Ytr, prob.alphas, cv_solver="schur-pallas")[0]
    preds = (E.predict_block(Xte, W), E.predict_block(Xim, W))
    for n_perms in (P, 1000):
        shuffles = torch.as_tensor(np.stack(create_null_distr_shuffled_indices(n_perms)),
                                   device=DEVICE)
        d = torch.as_tensor(draw_imagery_derangements(0, 0, B, n_perms), device=DEVICE)
        first = None
        for mode in E.NULL_GATHER_MODES:
            def score(mode=mode):
                return E.score_and_null_block(*preds, prob.Yte, prob.Yim, prob.layout,
                                              shuffles, d, null_gather=mode)[1]
            nulls = score()
            if first is None:
                first = nulls
            delta = max(float((nulls[k] - first[k]).abs().max()) for k in nulls)
            gathers[mode][f"null_scoring_ms_p{n_perms}"] = cuda_time_ms(score, reps=9,
                                                                        warmup=2)
            gathers[mode][f"max_abs_null_delta_p{n_perms}"] = delta
    bad = {m: g for m, g in gathers.items()
           if any(v != 0 for k, v in g.items() if k.startswith("max_abs"))}
    if bad:
        raise AssertionError(f"one-hot null gathers differ from the gather: {bad}")
    out["null_gathers"] = gathers
    out["masked_block_ms"] = gathers["gather"]["block_ms"]
    # the n-neighbours blocks at K on the same vertices, after one to warm up
    prob.block(patch["knn"][blocks[0]], None, der[0])
    torch.cuda.synchronize()
    t0 = time.time()
    for s, d in zip(blocks, der):
        prob.block(patch["knn"][s], None, d)
    out["n_neighbors_block_ms"] = (time.time() - t0) * 1e3 / len(blocks)
    return out


def radius_cli(info: dict) -> dict:
    """The searchlight CLI with --radius on phase cli's data set, the radius
    chosen for ~RD_KMEAN neighbours; its first block held to the column drop
    of the same standardised inputs the CLI reads."""
    import numpy as np

    from multimodal_decoding_tpu_torch.cli import run_searchlight as cli
    from multimodal_decoding_tpu_torch.config import LatentFeatsConfig
    from multimodal_decoding_tpu_torch.data.betas import get_fmri_surface_data
    from multimodal_decoding_tpu_torch.data.features import get_latent_features
    from multimodal_decoding_tpu_torch.data.preprocess import (
        standardize_fmri_betas,
        standardize_latents,
    )
    from multimodal_decoding_tpu_torch.io import artifacts
    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H
    from multimodal_decoding_tpu_torch.ops import metrics as M
    from multimodal_decoding_tpu_torch.parallel.searchlight_runner import (
        draw_imagery_derangements,
    )

    use_dataset(info)
    r = radius_for(info["mesh"].coordinates, RD_KMEAN)
    out_dir = WS.dir("radius_cli")
    H.reset_launches()
    HM.reset_launches()
    t0 = time.time()
    with PanelCalls() as calls:
        paths = quiet(cli.main, searchlight_argv(info, out_dir, "--radius", str(r)))
    cli_s = time.time() - t0
    launches = H.launches
    if len(paths) != 1 or any(HM.launches.values()):
        raise AssertionError(f"radius CLI: results {paths}, streamed {HM.launches}")
    res = artifacts.load_pickle(paths[0])
    counts, adjacency = res["n_neighbors"], res["adjacency"]
    kmax, n_vert = int(counts.max()), len(counts)
    leaves = schur_base_blocks(kmax)
    expected = -(-n_vert // B) * SCORER_CALLS_PER_BLOCK * len(leaves)
    calls.check("radius CLI", shapes=[(B, pb) for pb in set(leaves)])
    fails = []
    if sorted(res) != sorted(SL_RESULT_KEYS):
        fails.append(f"pickle keys {sorted(res)}, the JAX package's {sorted(SL_RESULT_KEYS)}")
    if res["distances"] is not None or counts.dtype != np.int32 or counts.shape != (n_vert,):
        fails.append(f"distances {type(res['distances'])}, n_neighbors {counts.dtype} "
                     f"{counts.shape}")
    if adjacency.shape != (n_vert, kmax):
        fails.append(f"adjacency {adjacency.shape}, expected ({n_vert}, {kmax})")
    if f"{os.sep}radius_{r}{os.sep}" not in paths[0]:
        fails.append(f"results path {paths[0]} lacks radius_{r}")
    means = {m: float(np.mean(res["score_maps"][m])) for m in (M.ACC_CAPTIONS, M.ACC_IMAGES)}
    if not all(np.all(np.isfinite(v)) and v.shape == (n_vert,)
               for v in res["score_maps"].values()) or min(means.values()) <= 0.9:
        fails.append(f"score maps: means {means}")
    if launches != expected:
        fails.append(f"{launches} chol_inv_panel launches, expected {expected}")
    if fails:
        raise AssertionError(f"radius CLI: {'; '.join(fails)}")

    # its first block against the column drop, from the inputs the CLI read
    betas_dir = os.path.join(info["betas_dir"], "surface")
    splits = [get_fmri_surface_data(betas_dir, "sub-01", s, hemi="left")[0]
              for s in ("train", "test", "imagery")]
    feats = LatentFeatsConfig("imagebind", verbose=False)
    lats = [get_latent_features(feats, "sub-01", s) for s in ("train", "test", "imagery")]
    prob = RadiusProblem(np.concatenate(standardize_fmri_betas(*splits)),
                         *standardize_latents(*lats))
    null = artifacts.load_null_scores_npz(os.path.join(os.path.dirname(paths[0]),
                                                       "null_distr.npz"))
    first = {m: v[:B] for m, v in res["score_maps"].items()}
    first["best_alpha"] = res["best_alpha"][:B]
    held = prob.hold_to_column_drop(first, {m: v[:B] for m, v in null.items()},
                                    adjacency[:B], counts[:B],
                                    draw_imagery_derangements(0, 0, B, P), "radius CLI block 0")
    return {"radius": r, "kmean": float(counts.mean()), "kmax": kmax,
            "kmin": int(counts.min()), "pad_waste": kmax / float(counts.mean()),
            "vertices": n_vert, "vertices_per_sec": res["vertices_per_sec"], "cli_s": cli_s,
            "results": os.path.relpath(paths[0], out_dir), "pickle_keys": sorted(res),
            "mean_acc": means, "launches": launches, "expected_launches": expected,
            "shapes": calls.shapes, "first_block_column_drop": held}


def phase_radius() -> dict:
    """Radius mode at fsaverage7 density on the card (phase radius)."""
    import numpy as np
    import torch

    from multimodal_decoding_tpu_torch.io.surface import icosphere, radius_adjacency

    coords = icosphere(RD_ICO).coordinates
    r = radius_for(coords, RD_KMEAN)
    torch.cuda.synchronize()
    t0 = time.time()
    idx, mask, counts = radius_adjacency(coords, r, device=DEVICE)
    adjacency_s = time.time() - t0
    if not np.array_equal(mask.sum(1), counts) or counts.dtype != np.int32:
        raise AssertionError(f"radius adjacency: mask sums differ from counts "
                             f"({counts.dtype})")
    out = {"vertices": len(coords), "radius": r, "kmean": float(counts.mean()),
           "kmax": int(counts.max()), "kmin": int(counts.min()),
           "pad_waste": int(counts.max()) / float(counts.mean()), "adjacency_s": adjacency_s,
           "count_flips": radius_count_flips(coords, r, idx, mask, counts)}
    emit({"radius_adjacency": out})
    out["blocks"] = radius_blocks(coords, idx, mask, counts)
    del idx, mask
    info = WS.runs["cli"]["info"] if "cli" in WS.runs else cli_dataset(WS.dir("radius_data"))
    out["cli"] = radius_cli(info)
    return out


class PanelCalls:
    """Records the panel kernel's calls on the Schur base blocks while it is
    entered (summed over every entry): each call's shape, whether its tensor
    was contiguous and on the card, and how often the plain version ran on a
    card tensor (it must not).  It wraps the functions the solver calls; the
    kernel's own count is untouched.  ``keep_inputs``: a copy of the last
    input of each shape is kept in ``inputs`` (the Schur recursion's last
    base block holds a radius neighbourhood's masked rows)."""

    def __init__(self, keep_inputs: bool = False):
        self.shapes, self.off_card, self.plain_on_card = {}, 0, 0
        self.keep_inputs, self.inputs = keep_inputs, {}

    def __enter__(self):
        from multimodal_decoding_tpu_torch.ops import hopper_solvers as H
        from multimodal_decoding_tpu_torch.ops import solvers as S

        self._kernel, self._plain = S.chol_inv_panel, H.chol_inv_panel_plain

        def kernel(a):
            key = str(list(a.shape))
            self.shapes[key] = self.shapes.get(key, 0) + 1
            self.off_card += int(a.device.type != "cuda" or not a.is_contiguous())
            if self.keep_inputs:
                self.inputs[key] = a.clone()
            return self._kernel(a)

        def plain(a):
            self.plain_on_card += int(a.device.type == "cuda")
            return self._plain(a)

        S.chol_inv_panel, H.chol_inv_panel_plain = kernel, plain
        return self

    def __exit__(self, *exc):
        from multimodal_decoding_tpu_torch.ops import hopper_solvers as H
        from multimodal_decoding_tpu_torch.ops import solvers as S

        S.chol_inv_panel, H.chol_inv_panel_plain = self._kernel, self._plain
        return False

    def check(self, where: str, shapes=WB_BASE_SHAPES) -> None:
        wrong = {k: v for k, v in self.shapes.items()
                 if k not in {str([b, pb, pb]) for b, pb in shapes}}
        if wrong or self.off_card or self.plain_on_card:
            raise AssertionError(f"{where}: panel calls {self.shapes}, {self.off_card} not "
                                 f"contiguous on the card, {self.plain_on_card} plain on the card")


def wb_gate_problem(rep: int, noise: float):
    """One planted-signal decode problem made on the card: betas X = Y G + noise
    (G [D, f] / sqrt(D)), the gram of its 8192 train rows and the query
    kernels of 140 test and 3 imagery rows."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(1000 + rep)
    n_all = N_TRAIN + N_TEST + N_IMAG
    Y = torch.randn((n_all, D), generator=gen, device=DEVICE)
    G = torch.randn((D, WB_GATE_F), generator=gen, device=DEVICE) / D ** 0.5
    X = Y @ G + noise * torch.randn((n_all, WB_GATE_F), generator=gen, device=DEVICE)
    Xtr = X[:N_TRAIN]
    return Xtr @ Xtr.T, X[N_TRAIN:] @ Xtr.T, Y


def wb_scores(K_q, dual, Y, stim_types) -> dict:
    """The whole-brain score family of the test and imagery predictions."""
    from multimodal_decoding_tpu_torch.ops import metrics as M

    preds = K_q @ dual
    return {k: float(v) for k, v in M.calc_all_pairwise_accuracy_scores(
        Y[N_TRAIN:N_TRAIN + N_TEST], preds[:N_TEST], stim_types,
        Y[N_TRAIN + N_TEST:], preds[N_TEST:]).items()}


def phase_wb_gate() -> dict:
    """The whole-brain selection gate (the procedure of the JAX package's
    benchmarks/check_wb_cv_parity.py, on the port)."""
    import numpy as np
    import torch

    from multimodal_decoding_tpu_torch.decoding.whole_brain import default_wb_cv_solver
    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H
    from multimodal_decoding_tpu_torch.ops.ridge import ridge_cv_dual

    cv_solver = default_wb_cv_solver(DEVICE)
    if cv_solver != "schur-pallas":
        raise AssertionError(f"CUDA whole-brain CV solver is {cv_solver!r}, not 'schur-pallas'")
    stim_types = np.array(["caption"] * (N_TEST // 2) + ["image"] * (N_TEST // 2))
    noise_scales = np.geomspace(0.5, 32.0, WB_GATE_REPS)  # strong signal -> near-noise
    problems, strict_s, fast_s = [], 0.0, 0.0
    calls = PanelCalls()
    for rep, noise in enumerate(noise_scales):
        K, K_q, Y = wb_gate_problem(rep, float(noise))
        torch.cuda.synchronize()
        t0 = time.time()
        s_idx, s_scores, s_dual = ridge_cv_dual(K, Y[:N_TRAIN], ALPHAS, device=DEVICE)
        torch.cuda.synchronize()
        strict_s += time.time() - t0
        H.reset_launches()
        HM.reset_launches()
        t0 = time.time()
        with calls:
            f_idx, f_scores, f_dual = ridge_cv_dual(K, Y[:N_TRAIN], ALPHAS,
                                                    cv_solver=cv_solver, device=DEVICE)
        torch.cuda.synchronize()
        fast_s += time.time() - t0
        launches, streamed = H.launches, sum(HM.launches.values())
        s_final, f_final = wb_scores(K_q, s_dual, Y, stim_types), wb_scores(K_q, f_dual, Y,
                                                                            stim_types)
        problems.append({
            "noise": float(noise), "strict_alpha": ALPHAS[s_idx], "fast_alpha": ALPHAS[f_idx],
            "cv_score_delta": float(np.max(np.abs(f_scores - s_scores))),
            "final_score_delta": max(abs(f_final[k] - s_final[k]) for k in s_final),
            "strict_cv_scores": s_scores.tolist(), "launches": launches,
            "acc_captions": s_final["pairwise_acc_captions"],
            "acc_images": s_final["pairwise_acc_images"]})
        del K, K_q, Y, s_dual, f_dual
        if streamed:
            raise AssertionError(f"problem {rep}: {streamed} streamed-count launches")
    calls.check("wb_gate")
    WS.runs["wb_gate"] = {"noise": [float(x) for x in noise_scales], "problems": problems}
    chosen = sorted({p["strict_alpha"] for p in problems})
    out = {"cv_solver": cv_solver, "reps": len(problems), "n": N_TRAIN, "f": WB_GATE_F, "d": D,
           "agreement": sum(p["strict_alpha"] == p["fast_alpha"] for p in problems),
           "distinct_alphas": chosen,
           "max_cv_score_delta": max(p["cv_score_delta"] for p in problems),
           "max_final_score_delta": max(p["final_score_delta"] for p in problems),
           "launches_per_fast_cv": sorted({p["launches"] for p in problems}),
           "panel_shapes": calls.shapes,
           "strict_s_per_cv": strict_s / len(problems), "fast_s_per_cv": fast_s / len(problems),
           "problems": problems}
    fails = []
    if out["agreement"] != len(problems):
        fails.append(f"best alpha differs on {len(problems) - out['agreement']} problems")
    if len(chosen) < MIN_DISTINCT_ALPHAS:
        fails.append(f"only {len(chosen)} distinct alphas chosen")
    if out["max_cv_score_delta"] > WB_CV_DELTA_MAX:
        fails.append(f"CV-score delta {out['max_cv_score_delta']:.3e} > {WB_CV_DELTA_MAX:g}")
    if out["max_final_score_delta"] > SCORE_DELTA_MAX:
        fails.append(f"final-score delta {out['max_final_score_delta']:.3e} > {SCORE_DELTA_MAX:g}")
    if out["launches_per_fast_cv"] != [WB_LAUNCHES]:
        fails.append(f"launches per fast CV {out['launches_per_fast_cv']}, not {WB_LAUNCHES}")
    if fails:
        raise AssertionError(f"wb_gate: {'; '.join(fails)}: {out}")
    return out


def precision_inputs(name: str, kind: str, seed: int) -> tuple:
    """Main-path-shaped inputs of a streamed scorer for the precision variants,
    on the card, laid out as streamed_inputs lays them out.  Integer inputs
    lie in -16..16, which bf16 holds exactly and float32 sums exactly, so
    every variant counts exactly: latent rows of sixteen +-1 entries (unit
    rows of +-1/4) and, for streamed_acc_from_inv, signed diagonal inverses
    of +-1, +-2, so Z = inv U stays an integer bf16 holds."""
    import torch

    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM

    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def draw(*shape):
        if kind == "integer":
            return torch.randint(-16, 17, shape, generator=gen, device=DEVICE).float()
        return torch.randn(shape, generator=gen, device=DEVICE)

    if name == "streamed_pairwise_acc":
        if kind == "integer":
            top = torch.rand((NV, D), generator=gen, device=DEVICE).topk(16, dim=-1).indices
            signs = torch.randint(0, 2, top.shape, generator=gen, device=DEVICE).float() * 2 - 1
            latents = torch.zeros((NV, D), device=DEVICE).scatter_(1, top, signs)
        else:
            latents = draw(NV, D)
        return draw(B, NV, D), latents
    Xv_b = draw(NV, B, K).permute(1, 0, 2)
    Z = HM.padded_empty(B, K, NV, DEVICE).copy_(draw(B, K, NV))
    if name == "streamed_acc_from_inv":
        if kind == "integer":
            vals = torch.tensor([-2.0, -1.0, 1.0, 2.0], device=DEVICE)
            inv = torch.diag_embed(vals[torch.randint(0, 4, (B, K), generator=gen,
                                                      device=DEVICE)])
        else:
            inv = draw(B, K, K) / K
        return Xv_b, inv, Z
    return Xv_b, Z


def bf16_passes(precision: str, *dtypes) -> int:
    """bf16 products per float32 product at ``precision``: one at "default";
    at "high" hi.hi + hi.lo + lo.hi, two where an operand is bf16 (it has no
    low part), as the kernels issue them."""
    import torch

    if precision == "default":
        return 1
    return 2 if torch.bfloat16 in dtypes else 3


def first_operand(name: str, x, dtype):
    """The first operand as the selection path hands it over: a bf16 Xv_b
    in the engine's padded rows (HM.padded_copy, tma_eligible), else the
    given layout in ``dtype``."""
    import torch

    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM

    if dtype == torch.bfloat16 and name != "streamed_pairwise_acc":
        return HM.padded_copy(x.permute(1, 0, 2), dtype).permute(1, 0, 2)
    return x.to(dtype)


def kernel_precision_variant(name: str, precision: str) -> dict:
    """One streamed-count kernel at ``precision`` against its plain version,
    with a float32 and a bf16 first operand, at the main path's shapes (the
    bf16 Xv_b in the engine's padded rows, loaded by TMA), and the rounding
    kernel on the operands the call rounds (``split_bit_equal``).
    streamed_acc_from_factors also takes Z as its bf16 planes beside the bf16
    Xv_b (``bfloat16_z_planes``: the selection path's form, factor_planes'),
    counted as the float32 Z they were rounded from."""
    import torch

    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM

    kernel, plain = getattr(HM, name), getattr(HM, name + "_plain")
    planes = HM.PLANES[precision]
    forms = [("float32", torch.float32, False), ("bfloat16", torch.bfloat16, False)]
    if name == "streamed_acc_from_factors":
        forms.append(("bfloat16_z_planes", torch.bfloat16, True))
    out = {}
    for key, a_dtype, z_planes in forms:
        def inputs(kind, seed):
            args = list(precision_inputs(name, kind, seed=seed))
            args[0] = first_operand(name, args[0], a_dtype)
            second = args[1]  # the float32 latents, inv or Z
            if z_planes:
                args[1] = HM.bf16_planes(second, planes)
            return args, second

        args, second = inputs("integer", 21)
        got, ref = kernel(*args, precision=precision), plain(*args, precision=precision)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"{name} at {precision}, {key}, integer inputs: counts "
                                 f"differ at {int((got != ref).sum())} of {B} vertices")
        if z_planes and not torch.equal(got, kernel(args[0], second, precision=precision)):
            raise AssertionError(f"{name} at {precision}: Z's planes count otherwise than "
                                 f"the float32 Z they were rounded from")
        del args, second, got, ref
        args, second = inputs("gaussian", 22)
        got, ref = kernel(*args, precision=precision), plain(*args, precision=precision)
        torch.cuda.synchronize()
        max_abs = float((got - ref).abs().max())
        if not (max_abs <= ACC_TOL):
            raise AssertionError(f"{name} at {precision}, {key}, Gaussian inputs: "
                                 f"max |acc - plain| {max_abs:.3e} > {ACC_TOL:g}")
        ms = cuda_time_ms(lambda: kernel(*args, precision=precision), reps=10, warmup=2)
        plain_ms = cuda_time_ms(lambda: plain(*args, precision=precision), reps=5, warmup=1)
        # the same products by cuBLAS, one bf16 pass with float32 output, no count
        b16 = [a.to(torch.bfloat16).contiguous() for a in (args[0], second, *args[2:])]
        if name == "streamed_pairwise_acc":
            y16 = HM._unit_rows(args[1]).mT.to(torch.bfloat16).contiguous()
            p16 = b16[0].reshape(B * NV, D)

            def library():
                return torch.mm(p16, y16, out_dtype=torch.float32)
        elif name == "streamed_acc_from_inv":
            def library():
                z = torch.bmm(b16[1], b16[2], out_dtype=torch.float32).to(torch.bfloat16)
                return torch.bmm(b16[0], z, out_dtype=torch.float32)
        else:
            def library():
                return torch.bmm(b16[0], b16[1], out_dtype=torch.float32)
        library_ms = cuda_time_ms(library, reps=10, warmup=2)
        # the count GEMM's second operand (latents, Z) is float32 (Z's planes
        # hold its hi and lo parts); B4's Z GEMM (inv U) takes two float32 operands
        depth = D if name == "streamed_pairwise_acc" else K
        flops = 2.0 * B * NV * NV * depth * bf16_passes(precision, a_dtype, torch.float32)
        if name == "streamed_acc_from_inv":
            flops += 2.0 * B * K * K * NV * bf16_passes(precision, torch.float32)
        # each input read once at its own width, the [B] accuracies written once
        in_bytes = sum(a.numel() * a.element_size() for a in args)
        bytes_ms = (in_bytes + B * 4) / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / BF16_FLOP_PER_S * 1e3
        if a_dtype == torch.float32:
            out["split_bit_equal"] = split_bit_equal(name, precision, args)
        out[key] = {"max_abs_err": max_abs, "integer_counts_equal": True, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": library_ms,
                    "library_ratio": ms / library_ms, "bound_ms": max(bytes_ms, flops_ms),
                    "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
                    "flops": flops, "tflops_per_s": flops / (ms * 1e-3) / 1e12,
                    **tc_parts(name, precision, args)}
        del args, second, got, ref, b16
    return out


def split_bit_equal(name: str, precision: str, args) -> dict:
    """The rounding kernel (HM.bf16_planes) bit for bit against its plain
    version on each float32 operand ``name``'s wrapper rounds at
    ``precision``, at the main path's shapes and in the views the wrapper
    hands it: the unit latents' transposed [1, D, nv] view and preds
    (streamed_pairwise_acc), inv [B, K, K] and U (streamed_acc_from_inv's Z
    GEMM), Z (streamed_acc_from_factors), and a float32 Xv_b (the
    transposed [nv, B, K] view).  Raises on the first that differs."""
    import torch

    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM

    planes = HM.PLANES[precision]
    if name == "streamed_pairwise_acc":
        operands = {"latents": HM._unit_rows(args[1]).mT.unsqueeze(0), "preds": args[0]}
    elif name == "streamed_acc_from_inv":
        operands = {"inv": args[1], "U": args[2], "Xv_b": args[0]}
    else:
        operands = {"Z": args[1], "Xv_b": args[0]}
    out = {}
    for key, t in operands.items():
        got, ref = HM.bf16_planes(t, planes), HM.bf16_planes_plain(t, planes)
        torch.cuda.synchronize()
        out[key] = {"shape": list(t.shape), "stride": list(t.stride()),
                    "equal": bool(torch.equal(got, ref))}
        if not out[key]["equal"]:
            raise AssertionError(f"{name} at {precision}: bf16_planes of {key} "
                                 f"{tuple(t.shape)} differs from its plain version at "
                                 f"{int((got != ref).sum())} elements")
        del got, ref
    return out


def tc_parts(name: str, precision: str, args) -> dict:
    """The stages of a tensor-core call timed apart (CUDA events): the
    rounding of float32 operands into bf16 planes (split_bf16), B4's Z GEMM
    (tc_store) and the count (tc_count).  With Z's planes handed to
    streamed_acc_from_factors the call is the count alone; their producer,
    factor_planes (the same Z GEMM at B4's shapes), is timed beside it."""
    import torch

    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM

    if name == "streamed_pairwise_acc":
        return {}
    planes = HM.PLANES[precision]
    timed = functools.partial(cuda_time_ms, reps=10, warmup=2)
    Xv_b = args[0]
    nv, k = Xv_b.shape[1], Xv_b.shape[2]
    if name == "streamed_acc_from_inv":
        inv, U = args[1], args[2]
        Z = HM.inv_times_u_on_card(inv, U, precision)
        parts = {"split_inv_u_ms": timed(lambda: (HM.bf16_planes(inv, planes),
                                                  HM.bf16_planes(U, planes))),
                 "z_gemm_with_split_ms": timed(lambda: HM.inv_times_u_on_card(inv, U,
                                                                              precision))}
    elif args[1].dim() == 4:
        Z = args[1]
        _, inv, U = precision_inputs("streamed_acc_from_inv", "gaussian", seed=23)
        parts = {"z_producer_ms": timed(lambda: HM.factor_planes(inv, U, precision))}
        del inv, U
    else:
        Z = HM.bf16_planes(args[1], planes)
        parts = {"split_z_ms": timed(lambda: HM.bf16_planes(args[1], planes))}
    parts["count_ms"] = timed(lambda: HM._count_tc(name, Xv_b, Z, False, B, nv, k, precision))
    del Z
    torch.cuda.synchronize()
    return parts


def precision_edge_cases() -> dict:
    """The tensor-core variants at the edges, against their plain versions on
    the card: nv 1 / 64 / 65 / 129 (one row or column tile, one past it) and
    1536 / 1537 / 1600 / 1639 / 1700 (the last column tile 256, 64, 64, 128
    and 192 columns wide), depth 16 / 17 / 750 (and D = 1024 for
    streamed_pairwise_acc), at default and high, a float32 first operand
    (rounded into planes, TMA), a bf16 one in padded rows (TMA) and the
    unpadded transposed view (vertex strides of kd x 2 bytes, even and odd
    vertices off 16-byte alignment: the wrapper's padded copy), Z in bf16
    and in hi/lo planes, rounded by the wrapper or handed over as planes
    (streamed_acc_from_factors with a bf16 first operand).
    Integer inputs: counts equal; Gaussian: within ACC_TOL or two flipped
    near-ties.  Also the rounding kernel (bf16_planes) bit for bit against
    its plain version."""
    import torch

    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM

    b, checked, fails = 5, 0, []
    for name, _ in STREAMED:
        depths = (16, 17, 750) + ((D,) if name == "streamed_pairwise_acc" else ())
        layouts = ["float32", "bfloat16_padded", "bfloat16_view"]
        if name == "streamed_acc_from_factors":
            layouts += ["bfloat16_padded+z_planes", "bfloat16_view+z_planes"]
        for nv in EDGE_NV:
            for kd in depths:
                for kind in ("integer", "gaussian"):
                    base = edge_inputs(name, kind, b, nv, kd, seed=nv * 131 + kd)
                    for layout in layouts:
                        args = list(base)
                        if layout.startswith("bfloat16_padded"):
                            args[0] = first_operand(name, base[0], torch.bfloat16)
                        elif layout.startswith("bfloat16_view"):
                            args[0] = base[0].to(torch.bfloat16)
                        for precision in TC_PRECISIONS:
                            if layout.endswith("z_planes"):
                                args[1] = HM.bf16_planes(base[1], HM.PLANES[precision])
                            before = HM.launches_by_precision[name][precision]
                            got = getattr(HM, name)(*args, precision=precision)
                            torch.cuda.synchronize()
                            ref = getattr(HM, name + "_plain")(*args, precision=precision)
                            err = float((got - ref).nan_to_num(0.0).abs().max())
                            tol = 0.0 if kind == "integer" else max(
                                ACC_TOL, 2.0 / max(nv * nv - nv, 1))
                            same_nan = torch.equal(got.isnan(), ref.isnan())
                            launched = HM.launches_by_precision[name][precision] - before
                            checked += 1
                            if not (err <= tol and same_nan and launched == 1):
                                fails.append(f"{name} {precision} {layout} {kind} nv={nv} "
                                             f"kd={kd}: err {err:.3e} (tol {tol:.3e}), "
                                             f"nan pattern equal {same_nan}, "
                                             f"{launched} launches")
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    x = torch.randn((3, 129, 1639), generator=gen, device=DEVICE) * 1e3
    for view in (x, x.mT, x[..., ::3]):
        for planes in (1, 2):
            got, ref = HM.bf16_planes(view, planes), HM.bf16_planes_plain(view, planes)
            checked += 1
            if not torch.equal(got, ref):
                fails.append(f"bf16_planes {tuple(view.stride())} x {planes}: differs from "
                             f"its plain version")
    if fails:
        raise AssertionError(f"tensor-core edge cases: {len(fails)} of {checked} failed: "
                             f"{'; '.join(fails[:20])}")
    return {"checked": checked, "vertices": b}


def edge_inputs(name: str, kind: str, b: int, nv: int, kd: int, seed: int) -> tuple:
    """Inputs of precision_inputs' kinds at an edge shape (on the card)."""
    import torch

    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM

    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def draw(*shape):
        if kind == "integer":
            return torch.randint(-16, 17, shape, generator=gen, device=DEVICE).float()
        return torch.randn(shape, generator=gen, device=DEVICE)

    if name == "streamed_pairwise_acc":
        if kind == "integer":
            n_on = 16 if kd >= 16 else 1
            top = torch.rand((nv, kd), generator=gen, device=DEVICE).topk(n_on, dim=-1).indices
            signs = torch.randint(0, 2, top.shape, generator=gen, device=DEVICE).float() * 2 - 1
            latents = torch.zeros((nv, kd), device=DEVICE).scatter_(1, top, signs)
        else:
            latents = draw(nv, kd)
        return draw(b, nv, kd), latents
    Xv_b = draw(nv, b, kd).permute(1, 0, 2)
    Z = HM.padded_empty(b, kd, nv, DEVICE).copy_(draw(b, kd, nv))
    if name == "streamed_acc_from_inv":
        if kind == "integer":
            vals = torch.tensor([-2.0, -1.0, 1.0, 2.0], device=DEVICE)
            inv = torch.diag_embed(vals[torch.randint(0, 4, (b, kd), generator=gen,
                                                      device=DEVICE)])
        else:
            inv = draw(b, kd, kd) / kd
        return Xv_b, inv, Z
    return Xv_b, Z


def precision_solvers() -> dict:
    """The bf16 and triangular-inverse solvers at [128, 750] over the
    production alphas, against Cholesky: within the JAX package's bands at
    "highest", printed at "default"; each method's ms at both."""
    import torch

    from multimodal_decoding_tpu_torch.ops.solvers import spd_solve

    gen = torch.Generator(device=DEVICE).manual_seed(31)
    X = torch.randn((B, N_TRAIN, K), generator=gen, device=DEVICE)
    G = X.mT @ X
    del X
    rhs = torch.randn((B, K, 64), generator=gen, device=DEVICE)
    eye = torch.eye(K, device=DEVICE)
    err = {m: {p: [] for p in ("highest", "default")} for m in SOLVER_BANDS}
    for alpha in ALPHAS:
        A = G + alpha * eye
        ref = spd_solve(A, rhs, "cholesky")
        scale = float(ref.abs().max())
        for method in SOLVER_BANDS:
            for prec in ("highest", "default"):
                got = spd_solve(A, rhs, method, precision=prec)
                err[method][prec].append(float((got - ref).abs().max()) / scale)
    A = G + ALPHAS[2] * eye
    out = {"shape": [B, K, K], "rhs": [B, K, 64], "alphas": ALPHAS,
           "cholesky_ms": cuda_time_ms(lambda: spd_solve(A, rhs, "cholesky"), reps=5)}
    fails = []
    for method, band in SOLVER_BANDS.items():
        out[method] = {
            "max_rel_err": {p: max(e) for p, e in err[method].items()},
            "rel_err_by_alpha": err[method], "band": band,
            "ms": {p: cuda_time_ms(lambda: spd_solve(A, rhs, method, precision=p), reps=5)
                   for p in ("highest", "default")}}
        if not max(err[method]["highest"]) < band:
            fails.append(f"{method}: max rel err {max(err[method]['highest']):.3e} "
                         f">= {band:g}")
    if fails:
        raise AssertionError(f"precision solvers: {'; '.join(fails)}: {out}")
    return out


def precision_selection() -> dict:
    """The gate's 2 blocks with bf16 selection storage on "schur-pallas" at
    each tensor-core precision, each scorer against the strict path, and
    fused-pallas against fused-inv: both count the same Z planes (Z's GEMM,
    then the tensor-core count), so their alphas, CV grids, final and null
    scores are equal bit for bit."""
    import numpy as np
    import torch

    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H

    gate = GateProblem()
    strict, strict_aux = gate.run(None, "strict")
    # the strict path's CV accuracies [2B, A], to price each swapped alpha
    grid = torch.cat(gate.cv_grids([("strict", None, "strict")])["strict"]).cpu().numpy()
    alpha_col = {a: i for i, a in enumerate(np.float32(ALPHAS))}
    strict_col = np.array([alpha_col[a] for a in strict_aux["best_alpha"]])
    out, fails = {"strict_vertices_per_sec": strict_aux["vertices_per_sec"]}, []
    fused = {}
    for precision, scorers in PRECISION_SCORERS.items():
        for scorer in scorers:
            H.reset_launches()
            HM.reset_launches()
            got, aux = gate.run("schur-pallas", scorer, cv_precision=precision,
                                cv_dtype=torch.bfloat16)
            if scorer in ("fused-pallas", "fused-inv"):
                fused[scorer, precision] = got, aux
            agree = aux["best_alpha"] == strict_aux["best_alpha"]
            equal_where_agree = (
                all(np.array_equal(got[m][agree], strict[m][agree]) for m in strict)
                and all(np.array_equal(aux["null_scores"][m][agree], v[agree])
                        for m, v in strict_aux["null_scores"].items()))
            kernel = STREAMED_SCORERS.get(scorer)
            expected = {k: dict.fromkeys(HM.launches_by_precision[k], 0) for k in HM.KERNELS}
            if kernel:
                expected[kernel][precision] = 2 * SCORER_CALLS_PER_BLOCK
            launches = {k: dict(v) for k, v in HM.launches_by_precision.items()}
            fast_col = np.array([alpha_col[a] for a in aux["best_alpha"]])
            rows = np.arange(len(fast_col))
            regret = grid[rows, strict_col] - grid[rows, fast_col]
            res = {**compare_paths(got, aux, strict, strict_aux),
                   "jax_bar": PRECISION_AGREEMENT_BAR, "default_gate_bar": ALPHA_AGREEMENT_MIN,
                   "max_strict_cv_regret": float(regret.max()),
                   "mean_strict_cv_regret_where_swapped": (
                       float(regret[~agree].mean()) if (~agree).any() else 0.0),
                   "final_scores_equal_where_alphas_agree": bool(equal_where_agree),
                   "chol_inv_panel_launches": H.launches,
                   "launches": {k: v for k, v in launches.items() if any(v.values())},
                   "vertices_per_sec": aux["vertices_per_sec"]}
            out[f"{scorer}:{precision}"] = res
            where = f"{scorer} at {precision}"
            if res["max_strict_cv_regret"] > SELECTION_REGRET_MAX:
                fails.append(f"{where}: a swapped alpha gives up "
                             f"{res['max_strict_cv_regret']:.3e} of strict CV accuracy "
                             f"> {SELECTION_REGRET_MAX:g}")
            if not equal_where_agree:
                fails.append(f"{where}: final scores differ where the alphas agree")
            if H.launches != 2 * LAUNCHES_PER_BLOCK:
                fails.append(f"{where}: {H.launches} chol_inv_panel launches, expected "
                             f"{2 * LAUNCHES_PER_BLOCK}")
            if launches != expected:
                fails.append(f"{where}: streamed launches {launches}, expected {expected}")
    for precision in TC_PRECISIONS:
        (got_p, aux_p), (got_i, aux_i) = fused["fused-pallas", precision], fused[
            "fused-inv", precision]
        grids = gate.cv_grids([(s, "schur-pallas", s) for s in ("fused-pallas", "fused-inv")],
                              cv_precision=precision, cv_dtype=torch.bfloat16)
        same = {
            "alphas": bool(np.array_equal(aux_p["best_alpha"], aux_i["best_alpha"])),
            "cv_grids": all(torch.equal(p, i) for p, i in zip(grids["fused-pallas"],
                                                               grids["fused-inv"])),
            "final_scores": all(np.array_equal(got_p[m], got_i[m]) for m in got_i),
            "null_scores": all(np.array_equal(aux_p["null_scores"][m], v)
                               for m, v in aux_i["null_scores"].items())}
        out[f"fused-pallas_equals_fused-inv:{precision}"] = same
        if not all(same.values()):
            fails.append(f"fused-pallas differs from fused-inv at {precision}: {same}")
    if fails:
        raise AssertionError(f"precision selection: {'; '.join(fails)}: {out}")
    return out


def precision_fast_math_cli() -> dict:
    """The searchlight CLI with --fast-math on phase cli's data set, against
    phase cli's float32 run."""
    import numpy as np
    import torch

    from multimodal_decoding_tpu_torch.cli import run_searchlight as cli
    from multimodal_decoding_tpu_torch.io import artifacts
    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H

    from multimodal_decoding_tpu_torch.parallel import searchlight_runner as R

    run = WS.runs["cli"]
    use_dataset(run["info"])
    argv = list(run["argv"])
    argv[argv.index("--out-dir") + 1] = WS.dir("cli_fast_math")
    H.reset_launches()
    HM.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    # the X_all every block step reads: its dtype and device bytes
    stored = set()
    steps = ("searchlight_block", "searchlight_block_with_null", "searchlight_block_cv",
             "searchlight_block_cv_with_null")
    originals = {n: getattr(R, n) for n in steps}

    def recording(fn):
        def step(X_all, *args, **kw):
            stored.add((str(X_all.dtype), X_all.untyped_storage().nbytes(), X_all.numel()))
            return fn(X_all, *args, **kw)
        return step

    for n, fn in originals.items():
        setattr(R, n, recording(fn))
    t0 = time.time()
    try:
        (path,) = quiet(cli.main, argv + ["--fast-math"])
    finally:
        for n, fn in originals.items():
            setattr(R, n, fn)
    cli_s = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res, ref = artifacts.load_pickle(path), artifacts.load_pickle(run["results"])
    n_vert = int((~res["nan_locations"]).sum())
    n_rows = N_TRAIN + N_TEST + N_IMAG
    deltas = {m: np.abs(res["score_maps"][m] - v) for m, v in ref["score_maps"].items()}
    out = {"x_all_stored": [{"dtype": d, "device_bytes": nb, "elements": ne}
                            for d, nb, ne in sorted(stored)],
           "x_all_bytes": {"bfloat16": n_rows * n_vert * 2, "float32": n_rows * n_vert * 4},
           "device_peak_gb": {"fast_math": peak_gb, "float32": run["peak_gb"]},
           "vertices_per_sec": {"fast_math": res["vertices_per_sec"],
                                "float32": ref["vertices_per_sec"]},
           "cli_s": {"fast_math": cli_s, "float32": run["cli_s"]},
           "alpha_agreement": float(np.mean(res["best_alpha"] == ref["best_alpha"])),
           "mean_final_score_delta": {m: float(d.mean()) for m, d in deltas.items()},
           "max_final_score_delta": float(max(d.max() for d in deltas.values())),
           "launches": H.launches}
    fails = []
    bad = [m for m, v in res["score_maps"].items()
           if v.shape != (n_vert,) or not np.all(np.isfinite(v))]
    if bad:
        fails.append(f"non-finite or misshapen maps {bad}")
    if [(d, nb) for d, nb, _ in stored] != [("torch.bfloat16", n_rows * n_vert * 2)]:
        fails.append(f"X_all stored as {sorted(stored)}, not {n_rows} x {n_vert} bf16")
    far = {m: v for m, v in out["mean_final_score_delta"].items()
           if not v <= FAST_MATH_SCORE_DELTA_MAX}
    if far:
        fails.append(f"mean |final score - float32 run's| {far} > {FAST_MATH_SCORE_DELTA_MAX}")
    if H.launches != run["launches"] or any(HM.launches.values()):
        fails.append(f"launches {H.launches} (float32 run {run['launches']}), streamed "
                     f"{HM.launches}")
    if fails:
        raise AssertionError(f"--fast-math CLI: {'; '.join(fails)}: {out}")
    return out


def precision_whole_brain() -> dict:
    """ridge_cv_dual at "default" on phase wb_gate's 16 problems, against their
    strict alphas and CV scores."""
    import numpy as np
    import torch

    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H
    from multimodal_decoding_tpu_torch.ops.ridge import ridge_cv_dual

    wb = WS.runs["wb_gate"]
    agree, deltas, launches, t = 0, [], set(), 0.0
    for rep, (noise, prob) in enumerate(zip(wb["noise"], wb["problems"])):
        Kg, _, Y = wb_gate_problem(rep, noise)
        H.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        idx, scores, _ = ridge_cv_dual(Kg, Y[:N_TRAIN], ALPHAS, cv_solver="schur-pallas",
                                       device=DEVICE, cv_precision="default")
        torch.cuda.synchronize()
        t += time.time() - t0
        launches.add(H.launches)
        agree += int(ALPHAS[idx] == prob["strict_alpha"])
        deltas.append(float(np.max(np.abs(scores - np.asarray(prob["strict_cv_scores"])))))
        del Kg, Y
    out = {"agreement": agree, "reps": len(wb["problems"]),
           "max_cv_score_delta": max(deltas), "s_per_cv": t / len(wb["problems"]),
           "launches_per_cv": sorted(launches)}
    if out["launches_per_cv"] != [WB_LAUNCHES]:
        raise AssertionError(f"whole-brain CV at default: launches {out['launches_per_cv']}, "
                             f"not {WB_LAUNCHES}: {out}")
    return out


def phase_precision() -> dict:
    """The TPU's reduced-precision selection path on the card (phase 8)."""
    if not {"cli", "wb_gate"} <= set(WS.runs):
        raise AssertionError("phase precision needs phases cli and wb_gate before it")
    out = {"kernels": {f"{name}:{precision}": kernel_precision_variant(name, precision)
                       for name, _ in STREAMED for precision in TC_PRECISIONS}}
    out["solvers"] = precision_solvers()
    out["selection"] = precision_selection()
    out["fast_math_cli"] = precision_fast_math_cli()
    out["whole_brain"] = precision_whole_brain()
    # last, so the timed runs above follow the same work as on earlier trees
    out["edge_cases"] = precision_edge_cases()
    return out


def phase_wb() -> dict:
    """One whole-brain decode at production scale from host numpy betas."""
    import numpy as np
    import torch

    from multimodal_decoding_tpu_torch.decoding.whole_brain import GramCache, decode_single
    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H
    from multimodal_decoding_tpu_torch.ops import metrics as M

    # planted signal made on the card, column block by column block, into host
    # arrays: X = Y G + WB_NOISE * E with G [D, V] / sqrt(D)
    t0 = time.time()
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    n_all = N_TRAIN + N_TEST + N_IMAG
    Y = torch.randn((n_all, D), generator=gen, device=DEVICE)
    rows = [(0, N_TRAIN), (N_TRAIN, N_TRAIN + N_TEST), (N_TRAIN + N_TEST, n_all)]
    X_train, X_test, X_imag = (np.empty((hi - lo, WB_V), dtype=np.float32) for lo, hi in rows)
    for lo in range(0, WB_V, 16384):
        hi = min(lo + 16384, WB_V)
        G = torch.randn((D, hi - lo), generator=gen, device=DEVICE) / D ** 0.5
        X = Y @ G + WB_NOISE * torch.randn((n_all, hi - lo), generator=gen, device=DEVICE)
        for host, (r0, r1) in zip((X_train, X_test, X_imag), rows):
            torch.from_numpy(host)[:, lo:hi].copy_(X[r0:r1])
    Y = Y.cpu().numpy()
    data_s = time.time() - t0

    torch.cuda.reset_peak_memory_stats()
    H.reset_launches()
    HM.reset_launches()
    cache = GramCache(X_train, X_test, X_imag, device=DEVICE)
    timings = {"gram_s": cache.gram_seconds}
    with PanelCalls() as calls:
        best_alpha, test_preds, imag_preds, cv_scores, fit_s = decode_single(
            X_train, X_test, X_imag, Y[:N_TRAIN], Y[N_TRAIN:N_TRAIN + N_TEST],
            Y[N_TRAIN + N_TEST:], ALPHAS, gram_cache=cache, timings=timings)
    launches, streamed = H.launches, sum(HM.launches.values())
    t1 = time.time()
    stim_types = np.array(["caption"] * (N_TEST // 2) + ["image"] * (N_TEST // 2))
    scores = {k: float(v) for k, v in M.calc_all_pairwise_accuracy_scores(
        Y[N_TRAIN:N_TRAIN + N_TEST], test_preds, stim_types, Y[N_TRAIN + N_TEST:], imag_preds,
        device=DEVICE).items()}
    torch.cuda.synchronize()
    timings["score_s"] = time.time() - t1
    calls.check("wb")
    # the streamed kernels against float64 host products on 8 train rows
    rows = np.arange(0, N_TRAIN, N_TRAIN // 8)
    x64 = X_train[rows].astype(np.float64)
    kernel_rel_err = max(
        float(np.abs(got.cpu().numpy() - ref).max() / np.abs(ref).max()) for got, ref in (
            (cache.K[rows][:, rows], x64 @ x64.T),
            (cache.K_test[:, rows], X_test.astype(np.float64) @ x64.T),
            (cache.K_imag[:, rows], X_imag.astype(np.float64) @ x64.T)))
    flops = 2.0 * N_TRAIN * WB_V * (N_TRAIN + N_TEST + N_IMAG)
    out = {"n_train": N_TRAIN, "n_test": N_TEST, "n_imag": N_IMAG, "v": WB_V, "d": D,
           "x_train_gb": X_train.nbytes / 1e9, "data_s": data_s, "stage_s": timings,
           "decode_s": sum(timings.values()), "best_alpha": best_alpha,
           "cv_mean_scores": cv_scores.tolist(), "scores": scores, "launches": launches,
           "panel_shapes": calls.shapes, "kernels_max_rel_err_vs_float64": kernel_rel_err,
           "kernels_flops": flops, "kernels_bound_s": flops / FP32_FLOP_PER_S,
           "kernels_tflops_per_s": flops / timings["gram_s"] / 1e12,
           "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
    if launches != WB_LAUNCHES or streamed:
        raise AssertionError(f"wb: {launches} chol_inv_panel launches (expected {WB_LAUNCHES}), "
                             f"{streamed} streamed: {out}")
    if not all(np.isfinite(v) for v in scores.values()) or test_preds.shape != (N_TEST, D):
        raise AssertionError(f"wb: bad output: {out}")
    if not kernel_rel_err <= WB_KERNEL_TOL:
        raise AssertionError(f"wb: gram/query kernels off float64 by {kernel_rel_err:.3e}: {out}")
    return out


def phase_wb_cli() -> dict:
    """The port's whole-brain CLI on a synthetic subject at full width."""
    import numpy as np

    from multimodal_decoding_tpu_torch import config
    from multimodal_decoding_tpu_torch.cli import decode_whole_brain as cli
    from multimodal_decoding_tpu_torch.data.features import _load_feature_pickle
    from multimodal_decoding_tpu_torch.data.synthetic import make_synthetic_dataset
    from multimodal_decoding_tpu_torch.decoding.whole_brain import get_run_str
    from multimodal_decoding_tpu_torch.io import artifacts
    from multimodal_decoding_tpu_torch.io.surface import icosphere
    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H
    from multimodal_decoding_tpu_torch.ops import metrics as M

    root = WS.dir("wb_cli")
    t0 = time.time()
    n_vertices = icosphere(4).n_vertices
    info = make_synthetic_dataset(root, n_train=N_TRAIN, n_vertices=n_vertices,
                                  latent_dim=D, model="imagebind")  # both hemispheres
    config.FMRI_STIM_INFO_DIR = info["stim_info_dir"]
    config.LATENT_FEATURES_DIR = info["features_dir"]
    config.BETAS_CACHE_DIR = os.path.join(root, "betas_cache")
    _load_feature_pickle.cache_clear()
    dataset_s = time.time() - t0

    out_dir = os.path.join(root, "wb")
    argv = ["--betas-dir", info["betas_dir"], "--subjects", "sub-01",
            "--models", "imagebind", "--surface",
            "--l2-regularization-alphas", *[str(a) for a in ALPHAS],
            "--out-dir", out_dir, "--device", DEVICE]
    H.reset_launches()
    HM.reset_launches()
    t1 = time.time()
    with PanelCalls() as calls:
        results = cli.main(argv)
    cli_s = time.time() - t1
    launches, streamed = H.launches, dict(HM.launches)
    rerun = cli.main(argv)

    path = os.path.join(out_dir, "agnostic", "sub-01", get_run_str(
        info["betas_dir"], config.LatentFeatsConfig("imagebind", verbose=False),
        surface=True), config.RESULTS_FILE)
    if len(results) != 1 or not os.path.isfile(path):
        raise AssertionError(f"wb_cli: {len(results)} results, results.p at {path}: "
                             f"{os.path.isfile(path)}")
    res = artifacts.load_pickle(path)
    schema = ["alpha", "model", "subject", "features", "training_mode", "num_voxels",
              "stimulus_ids", "stimulus_types", "predictions", "imagery_predictions",
              "latents", "imagery_latents"]
    missing = [k for k in schema if k not in res]
    accs = {m: res[m] for m in (M.ACC_CAPTIONS, M.ACC_IMAGES, M.ACC_IMAGERY,
                                M.ACC_IMAGERY_WHOLE_TEST)}
    out = {"vertices": int(res["num_voxels"]), "n_train": N_TRAIN, "d": D,
           "best_alpha": res["alpha"], "accuracies": accs, "launches": launches,
           "panel_shapes": calls.shapes, "rerun_results": len(rerun),
           "fit_seconds": res["fit_seconds"], "cli_s": cli_s, "dataset_s": dataset_s}
    fails = []
    if missing:
        fails.append(f"results.p lacks {missing}")
    if res["predictions"].shape != (N_TEST, D) or not np.all(np.isfinite(res["predictions"])):
        fails.append(f"predictions {res['predictions'].shape}")
    if min(accs[M.ACC_CAPTIONS], accs[M.ACC_IMAGES]) <= 0.9:
        fails.append(f"planted-signal accuracies too low: {accs}")
    if rerun != []:
        fails.append("the rerun did not skip")
    if launches != WB_LAUNCHES or any(streamed.values()):
        fails.append(f"launches {launches} (expected {WB_LAUNCHES}), streamed {streamed}")
    calls.check("wb_cli")
    if fails:
        raise AssertionError(f"wb_cli: {'; '.join(fails)}: {out}")
    WS.runs["wb_cli"] = {"info": info, "argv": argv, "results": path, "cli_s": cli_s}
    return out


def null_stacks(seed: int, n_members: int) -> list:
    """Seeded null scores [S, P, V] of each member metric, made on the card:
    accuracies around chance; NaN at 1% of each subject's vertices (the
    nan_locations scatter, shared by the subject's member metrics); degenerate
    vertices (every subject equal) in every member at 0.5% of the vertices and
    in the first member only at another 0.5%."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    cols = torch.randperm(ST_V, generator=gen, device=DEVICE)
    flat_all, flat_first = cols[:ST_V // 200], cols[ST_V // 200:ST_V // 100]
    nan_cols = [torch.randperm(ST_V, generator=gen, device=DEVICE)[:ST_V // 100]
                for _ in range(ST_S)]
    stacks = []
    for i in range(n_members):
        x = 0.5 + 0.05 * torch.randn((ST_S, ST_P, ST_V), generator=gen, device=DEVICE)
        x[:, :, flat_all] = 0.75
        if i == 0:
            x[:, :, flat_first] = 0.625
        for s, c in enumerate(nan_cols):
            x[s, :, c] = float("nan")
        stacks.append(x)
    return stacks


def t_map_float64(x, popmean: float):
    """[C, S, V] float32 scores -> [C, V] float64 t-maps, NaN where every
    subject is equal (the guard on the raw scores) or a score is NaN."""
    import numpy as np

    d = x.astype(np.float64) - popmean
    mean = d.mean(1)
    var = ((d - mean[:, None]) ** 2).sum(1) / (x.shape[1] - 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = mean / np.sqrt(var / x.shape[1])
    return np.where(np.all(x == x[:, :1], axis=1), np.nan, t)


def phase_stats() -> dict:
    """The group-statistics null at production width: the sweep on the card,
    TFCE on the host."""
    import numpy as np
    import torch

    from multimodal_decoding_tpu_torch.config import METRIC_MOD_AGNOSTIC_AND_CROSS
    from multimodal_decoding_tpu_torch.io.surface import edge_lengths, icosphere
    from multimodal_decoding_tpu_torch.ops import metrics as M
    from multimodal_decoding_tpu_torch.ops import stats as S
    from multimodal_decoding_tpu_torch.ops import tfce as T

    members = S.COMPOSITE_METRICS[METRIC_MOD_AGNOSTIC_AND_CROSS]
    popmeans = [M.CHANCE_VALUES[m] for m in members]
    perms = S.group_permutations(ST_P, ST_S, ST_GROUP)
    sampled = np.linspace(0, ST_GROUP - 1, ST_CHECK_PERMS).astype(np.int64)
    # HBM traffic of the sweep as written: per permutation and member, S
    # gathered rows read and one t-map row written
    sweep_bytes = ST_GROUP * len(members) * (ST_S + 1) * ST_V * 4
    # each input read once: every member's stack, and the min-maps written once
    once_bytes = (len(members) * ST_S * ST_P + ST_GROUP) * ST_V * 4
    bound_s = sweep_bytes / HBM_BYTES_PER_S
    t0 = time.time()
    mesh = icosphere(ST_ICO)
    edges, lengths = edge_lengths(mesh)
    mesh_s = time.time() - t0
    if mesh.n_vertices != ST_V:
        raise AssertionError(f"icosphere({ST_ICO}) has {mesh.n_vertices} vertices, not {ST_V}")

    hemis, fails = {}, []
    for h, hemi in enumerate(("left", "right")):
        stacks = null_stacks(11 + h, len(members))
        S.null_min_t_maps(stacks, perms[:ST_CHUNK], popmeans)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kept, checked = [], []
        t0 = time.time()
        for start, t_min in S.null_min_t_sweep(stacks, perms, popmeans, ST_CHUNK):
            if start < ST_TFCE_MAPS:
                kept.append(t_min)
            inside = sampled[(sampled >= start) & (sampled < start + len(t_min))]
            if len(inside):
                checked.append(t_min[torch.as_tensor(inside - start, device=DEVICE)])
        torch.cuda.synchronize()
        sweep_s = time.time() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the min-maps to the host: pageable copies, and into one reused pinned
        # buffer as the pipeline copies them (decoding/permutation.py)
        copy_gb = sum(k.numel() for k in kept) * 4 / 1e9
        t0 = time.time()
        host_maps = np.concatenate([k.cpu().numpy() for k in kept])[:ST_TFCE_MAPS]
        pageable_s = time.time() - t0
        t0 = time.time()
        pinned = torch.empty(kept[0].shape, dtype=torch.float32, pin_memory=True)
        pin_alloc_s = time.time() - t0
        t0 = time.time()
        for k in kept:
            pinned[:len(k)].copy_(k)
        pinned_s = time.time() - t0
        del pinned

        # the sampled permutations against a float64 t-map of the same scores
        got = torch.cat(checked).cpu().numpy()
        idx = torch.as_tensor(perms[sampled], dtype=torch.int64, device=DEVICE)
        subjects = torch.arange(ST_S, device=DEVICE)
        ref = np.fmin.reduce([t_map_float64(x[subjects[None, :], idx].cpu().numpy(), pm)
                              for x, pm in zip(stacks, popmeans)])
        ref[np.isinf(ref)] = np.nan
        del stacks, kept, checked
        torch.cuda.empty_cache()
        nan_equal = bool(np.array_equal(np.isnan(got), np.isnan(ref)))
        ok = ~np.isnan(ref)
        rel_err = float(np.abs(got[ok] - ref[ok]).max() / np.abs(ref[ok]).max())

        # host TFCE of the first min-maps, all threads, and one thread on a few
        t0 = time.time()
        tfce = T.tfce_map(host_maps, edges, lengths, h=2.0, e=1.0, dh=0.1)
        tfce_s = time.time() - t0
        t0 = time.time()
        one = T.tfce_map(host_maps[:16], edges, lengths, h=2.0, e=1.0, dh=0.1, n_threads=1)
        one_thread_ms = (time.time() - t0) / 16 * 1e3
        maxima = np.nanmax(np.where(np.isnan(tfce), -np.inf, tfce), axis=1)
        hemis[hemi] = {
            "sweep_s": sweep_s, "sweep_bound_s": bound_s, "sweep_share_of_bound": bound_s / sweep_s,
            "sweep_bytes": sweep_bytes, "read_once_bound_s": once_bytes / HBM_BYTES_PER_S,
            "peak_device_gb": peak_gb, "copied_gb": copy_gb,
            "pageable_copy_gb_per_s": copy_gb / pageable_s,
            "pinned_copy_gb_per_s": copy_gb / pinned_s, "pinned_alloc_s": pin_alloc_s,
            "check_perms": sampled.tolist(), "check_max_rel_err": rel_err,
            "check_nan_patterns_equal": nan_equal, "nan_share": float(np.isnan(ref).mean()),
            "tfce_maps": len(host_maps), "tfce_ms_per_map": tfce_s / len(host_maps) * 1e3,
            "tfce_one_thread_ms_per_map": one_thread_ms,
            "tfce_max_range": [float(maxima.min()), float(maxima.max())]}
        if not nan_equal or not rel_err <= ST_T_TOL:
            fails.append(f"{hemi}: t-maps off float64 (NaN patterns equal {nan_equal}, "
                         f"max rel err {rel_err:.3e} > {ST_T_TOL:g})")
        if not np.array_equal(one, tfce[:16]) or not np.all(np.isfinite(maxima)):
            fails.append(f"{hemi}: TFCE threads disagree or a map's max is not finite")
    threads = min(os.cpu_count() or 1, ST_TFCE_MAPS)
    tfce_ms = float(np.mean([v["tfce_ms_per_map"] for v in hemis.values()]))
    out = {"subjects": ST_S, "nulls_per_subject": ST_P, "vertices": ST_V,
           "group_permutations": ST_GROUP, "chunk": ST_CHUNK, "members": members,
           "mesh_s": mesh_s, "edges": len(edges), "hemis": hemis,
           "tfce_threads": threads, "cpu_count": os.cpu_count(),
           "usable_cpus": len(os.sched_getaffinity(0)),
           "projected_10k_both_hemis_s": {
               "sweep": sum(v["sweep_s"] for v in hemis.values()),
               "host_copy": sum(ST_GROUP * ST_V * 4 / 1e9 / v["pinned_copy_gb_per_s"]
                                for v in hemis.values()),
               "tfce": 2 * ST_GROUP * tfce_ms / 1e3}}
    if fails:
        raise AssertionError(f"stats: {'; '.join(fails)}: {out}")
    return out


def schur_base_blocks(k: int, base: int = 192) -> list:
    """Base-block sizes of the "schur-pallas" recursion at k: halves of
    (k + 1) // 2 and k // 2 until a block is <= base
    (ops/solvers.schur_spd_inverse)."""
    if k <= base:
        return [k]
    half = (k + 1) // 2
    return schur_base_blocks(half, base) + schur_base_blocks(k - half, base)


def quiet(fn, *args):
    """``fn(*args)`` with its standard output held back (a study prints many
    lines a searchlight run); the last lines are printed if it raises."""
    import contextlib
    import io

    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            return fn(*args)
    except Exception:
        print("\n".join(log.getvalue().splitlines()[-40:]), flush=True)
        raise


class Tally:
    """Counts the calls of ``module.name`` and sums their seconds while
    entered; ``after(result, *args, **kwargs)`` runs after each call, outside
    its seconds."""

    def __init__(self, module, name: str, after=None):
        self.module, self.name, self.after = module, name, after
        self.calls, self.seconds = 0, 0.0

    def __enter__(self):
        self._fn = fn = getattr(self.module, self.name)

        def wrapper(*args, **kwargs):
            t0 = time.time()
            try:
                result = fn(*args, **kwargs)
            finally:
                self.calls += 1
                self.seconds += time.time() - t0
            if self.after is not None:
                self.after(result, *args, **kwargs)
            return result

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._fn)
        return False


def export_expected(per_subject: dict, export_cli) -> dict:
    """{relative .gii path: float32 map} that ``export_cli`` writes for these
    scores: each subject's maps, the subject averages and their min-composites."""
    import warnings

    import numpy as np

    from multimodal_decoding_tpu_torch.config import FS_HEMI_NAMES

    subjects = list(per_subject)
    metrics = [m for m in export_cli.T_VAL_METRICS
               if all(m in per_subject[s]["left"] for s in subjects)]
    out = {}
    for hemi, fs in FS_HEMI_NAMES.items():
        averaged = {}
        for m in metrics:
            for s in subjects:
                out[os.path.join(s, f"{m}_{fs}.gii")] = np.asarray(per_subject[s][hemi][m],
                                                                   np.float32)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN vertices
                averaged[m] = np.nanmean([per_subject[s][hemi][m] for s in subjects], axis=0)
            out[os.path.join("avg", f"{m}_{fs}.gii")] = averaged[m].astype(np.float32)
        for name, members in export_cli.ACC_COMPOSITES.items():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                comp = np.nanmin(np.stack([averaged[m] for m in members]), axis=0)
            out[os.path.join("avg", f"{name}_{fs}.gii")] = comp.astype(np.float32)
    return out


def phase_study() -> dict:
    """The port's study CLI end to end on the card, then the permutation CLI."""
    import dataclasses

    import numpy as np

    from multimodal_decoding_tpu_torch import config
    from multimodal_decoding_tpu_torch.cli import export_results_maps as export_cli
    from multimodal_decoding_tpu_torch.cli import permutation_testing as perm_cli
    from multimodal_decoding_tpu_torch.cli import run_study as cli
    from multimodal_decoding_tpu_torch.data.features import _load_feature_pickle
    from multimodal_decoding_tpu_torch.data.synthetic import make_synthetic_dataset
    from multimodal_decoding_tpu_torch.decoding import permutation as PT
    from multimodal_decoding_tpu_torch.decoding import study as study_module
    from multimodal_decoding_tpu_torch.io.gifti import read_gifti
    from multimodal_decoding_tpu_torch.decoding.searchlight import (
        get_results_file_path,
        searchlight_mode_str,
    )
    from multimodal_decoding_tpu_torch.io import artifacts
    from multimodal_decoding_tpu_torch.io.surface import icosphere, write_freesurfer_geometry
    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H

    subjects = config.SUBJECTS[:SD_SUBJECTS]  # production's six
    hemis = ("left", "right")
    root = WS.dir("study")
    t0 = time.time()
    mesh = icosphere(SD_ICO)
    for i, subject in enumerate(subjects):
        info = make_synthetic_dataset(root, subject=subject, n_train=SD_N_TRAIN,
                                      n_vertices=mesh.n_vertices, latent_dim=D,
                                      model="imagebind", beta_seed=100 + i)
    config.FMRI_STIM_INFO_DIR = info["stim_info_dir"]
    config.LATENT_FEATURES_DIR = info["features_dir"]
    config.BETAS_CACHE_DIR = os.path.join(root, "betas_cache")
    _load_feature_pickle.cache_clear()
    mesh_dir = os.path.join(root, "surfaces", config.DEFAULT_RESOLUTION)
    os.makedirs(mesh_dir)
    for hemi in hemis:
        write_freesurfer_geometry(
            os.path.join(mesh_dir, f"{config.FS_HEMI_NAMES[hemi]}.inflated"), mesh)
    dataset_s = time.time() - t0

    sl_out, perm_out = os.path.join(root, "sl"), os.path.join(root, "perm")
    common = ["--subjects", *subjects, "--model", "imagebind", "--n-neighbors", str(SD_K),
              "--l2-regularization-alpha", "cv",
              "--n-permutations-group-level", str(SD_GROUP),
              "--p-value-threshold", str(SD_P_THRESHOLD),
              "--mesh-dir", os.path.join(root, "surfaces"), "--device", DEVICE]
    argv = ["--betas-dir", os.path.join(info["betas_dir"], "surface"),
            "--n-permutations-per-subject", str(P), "--block-size", str(B),
            "--searchlight-out-dir", sl_out, "--permutation-out-dir", perm_out, *common]
    H.reset_launches()
    HM.reset_launches()
    t1 = time.time()
    with PanelCalls() as calls, Tally(study_module, "run_permutation") as perm_stage, \
            Tally(PT, "null_max_tfce_statistics") as null_stage:
        stats = quiet(cli.main, argv)
    study_s = time.time() - t1
    launches, streamed = H.launches, dict(HM.launches)

    # a rerun skips every stage
    H.reset_launches()
    t1 = time.time()
    with Tally(PT, "load_per_subject_scores") as observed, \
            Tally(PT, "_stacked_null_scores") as nulls:
        rerun = quiet(cli.main, argv)
    rerun_s, rerun_launches = time.time() - t1, H.launches

    # every artifact at the JAX package's paths
    feats = config.LatentFeatsConfig("imagebind", verbose=False)
    mode = searchlight_mode_str(None, SD_K)
    results = [get_results_file_path(feats, hemi, s, m, config.DEFAULT_RESOLUTION, mode,
                                     "cv", sl_out)
               for m in config.TRAINING_MODES for s in subjects for hemi in hemis]
    pcfg = stats["permutation_config"]
    pdir, suffix = PT.permutation_results_dir(pcfg), PT.get_hparam_suffix(pcfg)
    maps_dir = os.path.join(pdir, "results_maps")
    expected = [*results,
                *(os.path.join(os.path.dirname(r), "null_distr.npz") for r in results),
                *(os.path.join(pdir, n) for n in ("t_values.p", f"tfce_values{suffix}.p",
                                                  f"null_max{suffix}.npz",
                                                  f"p_values{suffix}.p")),
                *(os.path.join(maps_dir, f"{kind}{suffix}_{fs}.gii")
                  for kind in ("p_values", "tfce_values", "mask") for fs in ("lh", "rh")),
                os.path.join(maps_dir, f"masks{suffix}.p"),
                os.path.join(maps_dir, f"clusters{suffix}.p")]
    missing = [os.path.relpath(p, root) for p in expected if not os.path.isfile(p)]

    # chol_inv_panel: every base block of every (alpha, fold) of every block
    bases = schur_base_blocks(SD_K)
    per_block = len(bases) * len(ALPHAS) * SD_FOLDS
    blocks = [-(-int((~artifacts.load_pickle(r)["nan_locations"]).sum()) // B)
              for r in results]
    expected_launches = sum(blocks) * per_block

    # the permutation CLI on the study's searchlight outputs, fresh out dir
    cli_out = os.path.join(root, "perm_cli")
    t1 = time.time()
    by_cli = quiet(perm_cli.main, ["--searchlight-out-dir", sl_out, "--out-dir", cli_out,
                                   *common])
    perm_cli_s = time.time() - t1
    null_max = np.load(os.path.join(pdir, f"null_max{suffix}.npz"))["null_max"]
    cli_null_max = np.load(os.path.join(PT.permutation_results_dir(
        dataclasses.replace(pcfg, out_dir=cli_out)), f"null_max{suffix}.npz"))["null_max"]

    def same_p(other):
        return all(np.array_equal(other["p_values"][h], stats["p_values"][h], equal_nan=True)
                   for h in hemis)

    # the export CLI on the study's searchlight outputs: every map reads back
    maps_out = os.path.join(root, "maps")
    t1 = time.time()
    quiet(export_cli.main, ["--subjects", *subjects, "--model", "imagebind", "--n-neighbors",
                            str(SD_K), "--l2-regularization-alpha", "cv",
                            "--searchlight-out-dir", sl_out, "--out-dir", maps_out])
    export_s = time.time() - t1
    exported = export_expected(PT.load_per_subject_scores(pcfg), export_cli)
    written = sorted(os.path.relpath(os.path.join(d, f), maps_out)
                     for d, _, fs in os.walk(maps_out) for f in fs)
    unequal_maps = [rel for rel in written if rel not in exported or not np.array_equal(
        read_gifti(os.path.join(maps_out, rel)).data, exported[rel], equal_nan=True)]

    n_sig = {h: int(stats["masks"][h].sum()) for h in hemis}
    first = artifacts.load_pickle(results[0])
    out = {"subjects": SD_SUBJECTS, "vertices_per_hemi": mesh.n_vertices,
           "n_train": SD_N_TRAIN, "k": SD_K, "d": D, "nulls_per_subject": P,
           "group_permutations": SD_GROUP, "p_value_threshold": SD_P_THRESHOLD,
           "searchlight_runs": len(stats["searchlight_outputs"]),
           "dataset_s": dataset_s, "study_s": study_s,
           "searchlights_s": study_s - perm_stage.seconds,
           "permutation_stage_s": perm_stage.seconds, "null_stage_s": null_stage.seconds,
           "rerun_s": rerun_s, "permutation_cli_s": perm_cli_s,
           "first_run_mean_acc": {m: float(np.mean(v))
                                  for m, v in first["score_maps"].items()},
           "significant_vertices": n_sig,
           "significance_cutoff": float(stats["significance_cutoff"]),
           "launches": launches, "expected_launches": expected_launches,
           "base_blocks": bases, "panel_shapes": calls.shapes,
           "rerun_launches": rerun_launches, "missing_artifacts": missing,
           "export": {"seconds": export_s, "maps": len(written), "expected": len(exported),
                      "unequal": unequal_maps}}
    fails = []
    if missing or sorted(stats["searchlight_outputs"]) != sorted(results):
        fails.append(f"artifacts: {len(missing)} missing, searchlight outputs "
                     f"{len(stats['searchlight_outputs'])} of {len(results)}")
    if sum(n_sig.values()) == 0:
        fails.append("no significant vertex on the planted signal")
    if launches != expected_launches or any(streamed.values()):
        fails.append(f"launches {launches} (expected {expected_launches}), "
                     f"streamed {streamed}")
    calls.check("study", shapes=[(B, pb) for pb in bases])
    if (rerun["searchlight_outputs"] or rerun_launches or observed.calls or nulls.calls
            or not same_p(rerun)):
        fails.append(f"the rerun did not skip: {len(rerun['searchlight_outputs'])} "
                     f"searchlights, {rerun_launches} launches, {observed.calls} score "
                     f"loads, {nulls.calls} null loads")
    if not np.array_equal(cli_null_max, null_max) or not same_p(by_cli):
        fails.append("the permutation CLI gave another null_max or other p-values")
    if unequal_maps or len(written) != len(exported):
        fails.append(f"export: {len(written)} maps of {len(exported)}, "
                     f"{len(unequal_maps)} do not read back as their maps")
    if fails:
        raise AssertionError(f"study: {'; '.join(fails)}: {out}")
    WS.runs["study"] = {"info": info, "common": common, "sl_out": sl_out, "root": root,
                        "null_max": null_max, "p_values": stats["p_values"],
                        "pcfg": pcfg, "permutation_cli_s": perm_cli_s}
    return out


class PeakRss:
    """Peak growth of this process's resident set over a ``with`` block, in
    bytes: VmRSS sampled every 2 ms on a thread.  (VmHWM cannot be reset
    where writing /proc/self/clear_refs is not permitted, and earlier phases
    leave it high.)"""

    def __enter__(self):
        import threading

        self.base = self.peak = proc_status_bytes("VmRSS")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self) -> None:
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, proc_status_bytes("VmRSS"))

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, proc_status_bytes("VmRSS"))
        self.growth = self.peak - self.base


def proc_status_bytes(key: str) -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    raise AssertionError(f"/proc/self/status has no {key}")


def write_betas_cache(path: str, rows, n_rows: int, n_cols: int) -> None:
    """A betas npz cache in np.savez's layout (ZIP_STORED members betas,
    stim_ids, stim_types), its betas written chunk by chunk from ``rows``
    (an iterator of float32 [r, n_cols] arrays), never whole in host memory."""
    import zipfile

    import numpy as np

    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        with zf.open("betas.npy", "w", force_zip64=True) as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": np.lib.format.dtype_to_descr(np.dtype(np.float32)),
                    "fortran_order": False, "shape": (n_rows, n_cols)})
            written = 0
            for chunk in rows:
                f.write(memoryview(np.ascontiguousarray(chunk)).cast("B"))
                written += len(chunk)
        if written != n_rows:
            raise AssertionError(f"{path}: wrote {written} rows, expected {n_rows}")
        for name, arr in (("stim_ids", np.arange(n_rows)),
                          ("stim_types", np.zeros(n_rows, np.int64))):
            with zf.open(name + ".npy", "w") as f:
                np.lib.format.write_array(f, arr)


def ingest_dataset(root: str):
    """The ingest phase's betas caches, made on the card from a seed.

    X = noise + Y W (W [D, V] graded over icosphere(7) like the gate's
    planted signal), 1% of the columns NaN in every row.  Returns (betas_dir,
    cache paths of train/test/imagery, Y splits as numpy, the mesh's
    coordinates).
    """
    import numpy as np
    import torch

    from multimodal_decoding_tpu_torch.config import SPLIT_IMAGERY, SPLIT_TEST, SPLIT_TRAIN
    from multimodal_decoding_tpu_torch.data.betas import surface_cache_path
    from multimodal_decoding_tpu_torch.io.surface import icosphere

    coords = icosphere(ST_ICO).coordinates
    if len(coords) != IN_V:
        raise AssertionError(f"icosphere({ST_ICO}) has {len(coords)} vertices, not {IN_V}")
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    n_all = N_TRAIN + N_TEST + N_IMAG
    z = torch.as_tensor(coords[:, 2] / (coords ** 2).sum(1) ** 0.5, device=DEVICE)
    W = torch.randn((D, IN_V), generator=gen, device=DEVICE) * 10.0 ** (-3.0 + 1.3 * (z + 1) / 2)
    Y = torch.randn((n_all, D), generator=gen, device=DEVICE)
    nan_cols = torch.randperm(IN_V, generator=gen, device=DEVICE)[:int(IN_V * IN_NAN_SHARE)]
    host = torch.empty((IN_CHUNK, IN_V), dtype=torch.float32, pin_memory=True)

    def rows(lo, hi):
        for r0 in range(lo, hi, IN_CHUNK):
            r1 = min(r0 + IN_CHUNK, hi)
            x = torch.randn((r1 - r0, IN_V), generator=gen, device=DEVICE) + Y[r0:r1] @ W
            x[:, nan_cols] = float("nan")
            yield host[:r1 - r0].copy_(x).numpy()

    betas_dir = os.path.join(root, "betas", "surface")
    paths = []
    for (lo, hi), split in zip([(0, N_TRAIN), (N_TRAIN, N_TRAIN + N_TEST),
                                (N_TRAIN + N_TEST, n_all)],
                               (SPLIT_TRAIN, SPLIT_TEST, SPLIT_IMAGERY)):
        paths.append(surface_cache_path(betas_dir, "sub-01", split, hemi="left"))
        os.makedirs(os.path.dirname(paths[-1]), exist_ok=True)
        write_betas_cache(paths[-1], rows(lo, hi), hi - lo, IN_V)
    Y = Y.cpu().numpy()
    return (betas_dir, paths, (Y[:N_TRAIN], Y[N_TRAIN:N_TRAIN + N_TEST], Y[N_TRAIN + N_TEST:]),
            coords)


def phase_ingest() -> dict:
    """Streamed betas ingestion against the eager path at production width."""
    import shutil

    import numpy as np
    import torch
    from scipy.spatial import cKDTree

    from multimodal_decoding_tpu_torch import config
    from multimodal_decoding_tpu_torch.config import SPLIT_IMAGERY, SPLIT_TEST, SPLIT_TRAIN
    from multimodal_decoding_tpu_torch.data.betas import get_fmri_surface_data
    from multimodal_decoding_tpu_torch.data.preprocess import standardize_fmri_betas
    from multimodal_decoding_tpu_torch.data.stimuli import create_null_distr_shuffled_indices
    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H
    from multimodal_decoding_tpu_torch.parallel.ingest import (
        NpzMemberReader,
        default_chunk_rows,
        streamed_scaler_fit,
        streamed_x_all_device,
    )
    from multimodal_decoding_tpu_torch.parallel.searchlight_runner import run_searchlight

    root = WS.dir("ingest")
    n_all = N_TRAIN + N_TEST + N_IMAG
    cache_gb = n_all * IN_V * 4 / 1e9
    free_gb = shutil.disk_usage(root).free / 1e9
    if free_gb < 1.5 * cache_gb:
        raise AssertionError(f"ingest: {free_gb:.1f} GB free under {root}, the betas caches "
                             f"need {cache_gb:.2f} GB")
    config.BETAS_CACHE_DIR = os.path.join(root, "betas_cache")
    t0 = time.time()
    betas_dir, paths, Y, coords = ingest_dataset(root)
    torch.cuda.synchronize()
    write_s = time.time() - t0

    # a plain read pass over the three files (they are in the page cache now)
    readers = [NpzMemberReader(p) for p in paths]
    rows = default_chunk_rows(IN_V)
    buf = np.empty((rows, IN_V), np.float32)
    t0 = time.time()
    for r in readers:
        for _ in r.iter_row_chunks(rows, buf):
            pass
    read_gb_per_s = cache_gb / (time.time() - t0)
    # one pinned chunk to the card, CUDA events
    pinned = torch.empty((rows, IN_V), dtype=torch.float32, pin_memory=True)
    card = torch.empty((rows, IN_V), dtype=torch.float32, device=DEVICE)
    h2d_ms = cuda_time_ms(lambda: card.copy_(pinned, non_blocking=True), reps=10, warmup=2)
    h2d_gb_per_s = pinned.numel() * 4 / 1e9 / (h2d_ms * 1e-3)
    del pinned, card, buf

    # streamed: two passes for the statistics, one for the upload
    with PeakRss() as streamed_rss:
        t0 = time.time()
        keep = ~np.isnan(readers[0].read_row(0))
        mean32, scale32 = streamed_scaler_fit(readers[0], keep)
        scaler_s = time.time() - t0
        t0 = time.time()
        X_stream = streamed_x_all_device(readers, keep, mean32, scale32, device=DEVICE)
        upload_s = time.time() - t0

    # eager: np.load of each cache, standardize_fmri_betas, concatenate, upload
    with PeakRss() as eager_rss:
        t0 = time.time()
        loaded = [get_fmri_surface_data(betas_dir, "sub-01", SPLIT_TRAIN, hemi="left")[0],
                  get_fmri_surface_data(betas_dir, "sub-01", SPLIT_TEST, hemi="left")[0],
                  get_fmri_surface_data(betas_dir, "sub-01", SPLIT_IMAGERY, hemi="left")[0]]
        load_s = time.time() - t0
        t0 = time.time()
        eager = standardize_fmri_betas(*loaded)
        standardize_s = time.time() - t0
        t0 = time.time()
        X_eager = torch.as_tensor(np.concatenate(eager), device=DEVICE)
        torch.cuda.synchronize()
        eager_upload_s = time.time() - t0
    del eager
    # the eager statistics, as standardize_fmri_betas computes them
    train = np.ascontiguousarray(loaded[0][:, keep])
    del loaded
    e_mean = train.mean(axis=0, dtype=np.float64).astype(np.float32)
    std64 = np.sqrt(np.var(train, axis=0, dtype=np.float64))
    e_scale = np.where(std64 == 0.0, 1.0, std64).astype(np.float32)
    del train, std64
    stats_equal = bool(np.array_equal(mean32, e_mean) and np.array_equal(scale32, e_scale))
    tensors_equal = bool(torch.equal(X_stream, X_eager))
    # fast math's bf16 stream: the eager float32 X_all cast to bf16, exactly
    t0 = time.time()
    X_bf16 = streamed_x_all_device(readers, keep, mean32, scale32, device=DEVICE,
                                   dtype=torch.bfloat16)
    bf16_upload_s = time.time() - t0
    bf16_equal = bool(torch.equal(X_bf16, X_eager.to(torch.bfloat16)))
    del X_bf16

    # two runner blocks from each tensor
    kept = coords[keep]
    adjacency = cKDTree(kept).query(kept[:2 * B], k=K)[1].astype(np.int32)
    shuffles = np.stack(create_null_distr_shuffled_indices(P)).astype(np.int32)
    stim_types = np.array(["caption"] * (N_TEST // 2) + ["image"] * (N_TEST // 2))

    def run(X):
        return run_searchlight(None, None, None, *Y, adjacency, stim_types, alphas_cv=ALPHAS,
                               shuffles=shuffles, block_size=B, device=DEVICE,
                               cv_solver="schur-pallas", progress=False, x_all_device=X,
                               n_rows_split=(N_TRAIN, N_TEST, N_IMAG))

    H.reset_launches()
    got, got_aux = run(X_stream)
    launches = H.launches
    ref, ref_aux = run(X_eager)
    runs_equal = (all(np.array_equal(got[m], ref[m]) for m in ref)
                  and np.array_equal(got_aux["best_alpha"], ref_aux["best_alpha"])
                  and all(np.array_equal(got_aux["null_scores"][m], v)
                          for m, v in ref_aux["null_scores"].items()))
    del X_stream, X_eager
    torch.cuda.empty_cache()
    x_gb = n_all * int(keep.sum()) * 4 / 1e9
    out = {"rows": [N_TRAIN, N_TEST, N_IMAG], "vertices": IN_V, "kept": int(keep.sum()),
           "cache_gb": cache_gb, "x_all_gb": x_gb, "disk_free_gb": free_gb,
           "cache_dir": config.BETAS_CACHE_DIR, "write_s": write_s,
           "read_gb_per_s": read_gb_per_s, "h2d_gb_per_s": h2d_gb_per_s,
           "streamed": {"scaler_s": scaler_s, "upload_s": upload_s,
                        "upload_gb_per_s": x_gb / upload_s,
                        "host_peak_gb": streamed_rss.growth / 1e9},
           "eager": {"load_s": load_s, "standardize_s": standardize_s,
                     "upload_s": eager_upload_s, "host_peak_gb": eager_rss.growth / 1e9},
           "statistics_bitwise_equal": stats_equal, "x_all_equal": tensors_equal,
           "bf16_upload_s": bf16_upload_s, "bf16_x_all_equal_eager_cast": bf16_equal,
           "runs_equal": bool(runs_equal), "launches": launches,
           "expected_launches": 2 * LAUNCHES_PER_BLOCK,
           "streamed_vertices_per_sec": got_aux["vertices_per_sec"],
           "best_alpha_counts": {f"{a:g}": int(c) for a, c in
                                 zip(*np.unique(got_aux["best_alpha"], return_counts=True))}}
    fails = []
    if not stats_equal:
        fails.append("streamed statistics differ from the eager ones")
    if not tensors_equal:
        fails.append("the streamed X_all differs from the eager one")
    if not bf16_equal:
        fails.append("the streamed bf16 X_all differs from the eager one cast to bf16")
    if not runs_equal:
        fails.append("the runner's outputs differ between the two tensors")
    if launches != 2 * LAUNCHES_PER_BLOCK:
        fails.append(f"{launches} chol_inv_panel launches, expected {2 * LAUNCHES_PER_BLOCK}")
    shutil.rmtree(root)
    if fails:
        raise AssertionError(f"ingest: {'; '.join(fails)}: {out}")
    return out


def phase_dist() -> dict:
    """The multi-GPU paths on a world of one NCCL rank, each against its
    unsharded run."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from multimodal_decoding_tpu_torch import config
    from multimodal_decoding_tpu_torch import entry as E
    from multimodal_decoding_tpu_torch.cli import decode_whole_brain as wb_cli
    from multimodal_decoding_tpu_torch.cli import permutation_testing as perm_cli
    from multimodal_decoding_tpu_torch.data.features import _load_feature_pickle
    from multimodal_decoding_tpu_torch.decoding import permutation as PT
    from multimodal_decoding_tpu_torch.io import artifacts
    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H
    from multimodal_decoding_tpu_torch.parallel.mesh import vertex_mesh

    if not {"wb_cli", "study"} <= set(WS.runs):
        raise AssertionError("phase dist needs phases wb_cli and study before it")
    out, fails = {}, []
    mesh = vertex_mesh(DEVICE)
    out["world"] = {"backend": dist.get_backend(), "size": mesh.size, "device": str(mesh.device)}
    try:
        # (1) the gate's two blocks, vertex-sharded against one device
        gate = GateProblem()
        H.reset_launches()
        HM.reset_launches()
        t0 = time.time()
        got, got_aux = gate.run("schur-pallas", "xla", mesh=mesh)
        sl_mesh_s = time.time() - t0
        sl_launches, streamed = H.launches, sum(HM.launches.values())
        t0 = time.time()
        ref, ref_aux = gate.run("schur-pallas", "xla")
        sl_s = time.time() - t0
        alphas_equal = bool(np.array_equal(got_aux["best_alpha"], ref_aux["best_alpha"]))
        nulls_equal = all(np.array_equal(got_aux["null_scores"][m], v)
                          for m, v in ref_aux["null_scores"].items())
        close = all(np.allclose(got[m], ref[m], rtol=DIST_RTOL, atol=DIST_ATOL) for m in ref)
        out["searchlight"] = {"mesh_s": sl_mesh_s, "one_device_s": sl_s,
                              "launches": sl_launches, **compare_paths(got, got_aux, ref, ref_aux)}
        if not (alphas_equal and nulls_equal and close):
            fails.append(f"searchlight: alphas equal {alphas_equal}, nulls equal "
                         f"{nulls_equal}, scores within the bar {close}")
        if sl_launches != 2 * LAUNCHES_PER_BLOCK or streamed:
            fails.append(f"searchlight: {sl_launches} chol_inv_panel launches (expected "
                         f"{2 * LAUNCHES_PER_BLOCK}), {streamed} streamed")

        # (2) the whole-brain CLI with --multichip on phase wb_cli's data set
        wb = WS.runs["wb_cli"]
        config.FMRI_STIM_INFO_DIR = wb["info"]["stim_info_dir"]
        config.LATENT_FEATURES_DIR = wb["info"]["features_dir"]
        config.BETAS_CACHE_DIR = os.path.join(os.path.dirname(wb["info"]["stim_info_dir"]),
                                              "betas_cache")
        _load_feature_pickle.cache_clear()
        argv = list(wb["argv"])
        wb_out = WS.dir("wb_multichip")
        argv[argv.index("--out-dir") + 1] = wb_out
        H.reset_launches()
        t0 = time.time()
        with PanelCalls() as calls:
            (multi,) = quiet(wb_cli.main, argv + ["--multichip"])
        wb_mesh_s = time.time() - t0
        wb_launches = H.launches
        plain = artifacts.load_pickle(wb["results"])
        accs = {m: (multi[m], plain[m]) for m in ("pairwise_acc_captions", "pairwise_acc_images",
                                                  "pairwise_acc_imagery",
                                                  "pairwise_acc_imagery_whole_test_set")}
        out["whole_brain_cli"] = {"multichip_cli_s": wb_mesh_s, "one_device_cli_s": wb["cli_s"],
                                  "launches": wb_launches, "accuracies": accs,
                                  "panel_shapes": calls.shapes}
        calls.check("dist whole-brain")
        if any(a != b for a, b in accs.values()) or not np.array_equal(
                multi["predictions"], plain["predictions"]):
            fails.append(f"whole-brain --multichip: accuracies {accs} or predictions differ")
        if wb_launches != WB_LAUNCHES:
            fails.append(f"whole-brain --multichip: {wb_launches} launches, not {WB_LAUNCHES}")

        # (3) the permutation CLI with --sharded on phase study's searchlights
        study = WS.runs["study"]
        perm_out = WS.dir("perm_sharded")
        t0 = time.time()
        sharded = quiet(perm_cli.main, ["--searchlight-out-dir", study["sl_out"], "--out-dir",
                                        perm_out, *study["common"], "--sharded"])
        perm_mesh_s = time.time() - t0
        pcfg = dataclasses.replace(study["pcfg"], out_dir=perm_out)
        null_max = np.load(os.path.join(PT.permutation_results_dir(pcfg),
                                        f"null_max{PT.get_hparam_suffix(pcfg)}.npz"))["null_max"]
        same_p = all(np.array_equal(sharded["p_values"][h], p, equal_nan=True)
                     for h, p in study["p_values"].items())
        out["permutation_cli"] = {"sharded_cli_s": perm_mesh_s,
                                  "one_device_cli_s": study["permutation_cli_s"],
                                  "null_max_equal": bool(np.array_equal(null_max,
                                                                        study["null_max"])),
                                  "p_values_equal": same_p}
        if not out["permutation_cli"]["null_max_equal"] or not same_p:
            fails.append("permutation --sharded: another null_max or other p-values")

        # (4) the entry block step and the dry run
        H.reset_launches()
        fn, args = E.entry(DEVICE)
        block = fn(*args)
        entry_launches = H.launches
        t0 = time.time()
        preds, scores = quiet(E.dryrun_multichip, 1, DEVICE)
        out["entry"] = {"shape": list(block.shape), "finite": bool(block.isfinite().all()),
                        "launches": entry_launches, "dryrun_s": time.time() - t0,
                        "dryrun_preds_shape": list(preds.shape), "dryrun_maps": len(scores),
                        "dryrun_cvtpu_maps": sum(m.startswith("cvtpu_") for m in scores)}
        if not out["entry"]["finite"]:
            fails.append("entry(): non-finite block scores")
        if "cvtpu_best_alpha" not in scores:  # step (3b): bf16 selection at "default"
            fails.append(f"dryrun_multichip: no step (3b) maps among {sorted(scores)}")
    finally:
        dist.destroy_process_group()
    if fails:
        raise AssertionError(f"dist: {'; '.join(fails)}: {out}")
    return out


def phase_flips() -> dict:
    """On request: the analyses' production null drawn once more through
    ``null_draws``, its count digest beside the JAX package's, and its
    comparisons ``d_ii < d_ij`` decided once in float32 (the port's path) and
    once in float64 from the same normals: how many differ."""
    import torch

    from multimodal_decoding_tpu_torch.analysis import calibration as AC
    from multimodal_decoding_tpu_torch.ops.metrics import cosine_distances
    from multimodal_decoding_tpu_torch.utils import threefry as T

    accs, _, _ = AC.null_draws(AN_PERMS, AN_S, AN_L, AN_P, AN_D, seed=0, device=DEVICE)
    digest = count_digest(accs)
    keys = T.split(T.prng_key(0), AN_PERMS)
    flips, comparisons, max_abs_d = 0, 0, 0.0
    for start in range(0, AN_PERMS, AC.CHUNK):
        ks = T.split_torch(keys[start:start + AC.CHUNK], 2, DEVICE)
        lat = T.normal_torch(ks[:, 0], (AN_S, AN_L, AN_D))
        pred = T.normal_torch(ks[:, 1], (AN_S, AN_P, AN_D))
        wins = []
        for dtype in (torch.float32, torch.float64):
            d = cosine_distances(pred.to(dtype), lat.to(dtype))  # [C, S, P, L]
            wins.append(torch.diagonal(d, dim1=-2, dim2=-1)[..., :, None] < d)
            if dtype == torch.float64:
                max_abs_d = max(max_abs_d, float((d - d32).abs().max()))
            d32 = d
        flips += int((wins[0] != wins[1]).sum())
        comparisons += wins[0].numel() - wins[0].shape[0] * AN_S * AN_P
        del lat, pred, wins, d, d32
    return {"count_digest": list(digest), "jax_count_digest": list(AN_JAX_COUNT_DIGEST),
            "count_sum_delta": digest[0] - AN_JAX_COUNT_DIGEST[0],
            "float32_vs_float64_flips": flips, "comparisons": comparisons,
            "max_abs_distance_delta": max_abs_d}


def count_digest(accs) -> tuple:
    """(sum, index-weighted sum) of the null's integer counts ``acc * 216``."""
    import numpy as np

    counts = np.round(np.asarray(accs, np.float64) * AN_DENOM).astype(np.int64)
    idx = np.arange(1, counts.size + 1, dtype=np.int64).reshape(counts.shape)
    return int(counts.sum()), int((counts * idx).sum())


def phase_analyses() -> dict:
    """The analyses on the card: the Monte-Carlo t calibration at the
    reference's production shape, the two-modality simulation's ridge
    classifier at full width, and CSLS."""
    import math

    import numpy as np
    import torch

    from multimodal_decoding_tpu_torch.analysis import calibration as AC
    from multimodal_decoding_tpu_torch.analysis import simulation as AS
    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H
    from multimodal_decoding_tpu_torch.ops.metrics import get_distance_matrix_csls
    from multimodal_decoding_tpu_torch.utils import threefry as T

    out, fails = {}, []
    H.reset_launches()
    HM.reset_launches()

    # (1) the card's draws against the numpy draws, bit for bit, on one chunk
    keys = T.split(T.prng_key(0), 2)
    ks = T.split_torch(keys, 2, DEVICE)
    drawn = {"latents": T.normal_torch(ks[:, 0], (AN_S, AN_L, AN_D)).cpu().numpy(),
             "predictions": T.normal_torch(ks[:, 1], (AN_S, AN_P, AN_D)).cpu().numpy()}
    unequal = 0
    for i, k in enumerate(keys):
        sub = T.split(k, 2)
        unequal += int((drawn["latents"][i].view(np.int32)
                        != T.normal(sub[0], (AN_S, AN_L, AN_D)).view(np.int32)).sum())
        unequal += int((drawn["predictions"][i].view(np.int32)
                        != T.normal(sub[1], (AN_S, AN_P, AN_D)).view(np.int32)).sum())
    out["draws_checked"] = sum(v.size for v in drawn.values())
    out["draws_unequal"] = unequal
    if unequal:
        fails.append(f"{unequal} card normals differ from the numpy draws")

    # (2) the production calibration on the card
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with Tally(AC, "null_draws") as null:
        cutoffs = AC.t_threshold_monte_carlo(
            n_perms=AN_PERMS, n_subjects=AN_S, n_latents=AN_L, n_preds=AN_P, dim=AN_D,
            p_vals=AN_P_VALS, seed=0, device=DEVICE)
    calib_s = time.time() - t0
    cal = {"seconds": calib_s, "null_draws_s": null.seconds, "chunk": AC.CHUNK,
           "normals": AN_PERMS * AN_S * (AN_L + AN_P) * AN_D,
           "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
           "cutoffs": {str(p): list(v) for p, v in cutoffs.items()},
           "jax_cutoffs": {str(p): list(v) for p, v in AN_JAX_CUTOFFS.items()}}
    cal["normals_per_s"] = cal["normals"] / null.seconds
    for p, (ref_cut, ref_min) in AN_JAX_CUTOFFS.items():
        cut, min_acc = cutoffs[p]
        if abs(cut - ref_cut) > AN_CUTOFF_RTOL * abs(ref_cut):
            fails.append(f"cutoff at p={p}: {cut} against the JAX package's {ref_cut}")
        if math.isnan(ref_min) != math.isnan(min_acc) or (
                not math.isnan(ref_min) and abs(min_acc - ref_min) > AN_CUTOFF_RTOL * ref_min):
            fails.append(f"min accuracy at p={p}: {min_acc} against {ref_min}")
    out["calibration"] = cal

    # (3) the simulation's classifier at full width, card against the CPU
    compared = {"labels": 0, "agree": 0, "cpu_fit_s": 0.0}
    fit_fn = AS.ridge_classifier_fit_predict

    def against_cpu(preds, train_x, train_y, test_xs, alpha, n_classes, device):
        t1 = time.time()
        ref = fit_fn(train_x, train_y, test_xs, alpha, n_classes, device="cpu")
        compared["cpu_fit_s"] += time.time() - t1
        for g, r in zip(preds, ref):
            compared["labels"] += r.size
            compared["agree"] += int((g == r).sum())

    rows = []
    with Tally(AS, "generate_condition_data") as gen, \
            Tally(AS, "ridge_classifier_fit_predict", against_cpu) as fit:
        for condition in AN_SIM_CONDITIONS:
            rows += AS.train_and_eval(condition, n_seeds=AN_SIM_SEEDS, device=DEVICE)
    n_fits = fit.calls
    per_fit = (gen.seconds + fit.seconds) / n_fits
    full = len(AS.SECOND_MODALITY_CONDITIONS) * 3 * 10  # run_all_conditions(n_seeds=10)
    mean_acc = {f"{c}/{d}/{m}": float(np.mean([r["acc"] for r in rows if
                                               (r["condition"], r["decoder_type"],
                                                r["modality"]) == (c, d, m)]))
                for c in AN_SIM_CONDITIONS
                for d in ("modality_agnostic", "modality_specific_mod1",
                          "modality_specific_mod2") for m in ("mod1", "mod2", "avg")}
    agreement = compared["agree"] / compared["labels"]
    out["simulation"] = {
        "conditions": list(AN_SIM_CONDITIONS), "n_seeds": AN_SIM_SEEDS, "fits": n_fits,
        "classes": AS.N_CLASSES, "voxels": AS.N_VOXELS_FMRI,
        "host_data_s": gen.seconds, "device_fit_s": fit.seconds,
        "cpu_fit_s": compared["cpu_fit_s"], "label_agreement": agreement,
        "labels_compared": compared["labels"],
        "run_all_conditions_fits": full, "run_all_conditions_projected_s": per_fit * full,
        "run_all_conditions_projected_host_s": gen.seconds / n_fits * full,
        "mean_acc": mean_acc}
    if agreement < AN_LABEL_AGREEMENT_MIN:
        fails.append(f"simulation labels agree on {agreement} of the test samples")
    if not (mean_acc["gauss_same_stddev/modality_agnostic/avg"] > 0.4
            and mean_acc["just_noise/modality_specific_mod2/mod2"] < 0.05):
        fails.append(f"simulation accuracies off: {mean_acc}")

    # (4) CSLS on the card against the CPU
    rng = np.random.RandomState(0)
    preds = rng.randn(N_TEST, D).astype(np.float32)
    lats = rng.randn(N_TEST, D).astype(np.float32)
    got = get_distance_matrix_csls(preds, lats, knn=AN_KNN, device=DEVICE)
    ref = get_distance_matrix_csls(preds, lats, knn=AN_KNN, device="cpu")
    err = float((got.cpu() - ref).abs().max())
    p_card = torch.as_tensor(preds, device=DEVICE)
    l_card = torch.as_tensor(lats, device=DEVICE)
    out["csls"] = {"shape": [N_TEST, D], "knn": AN_KNN, "max_abs_err": err,
                   "ms": cuda_time_ms(lambda: get_distance_matrix_csls(p_card, l_card,
                                                                       knn=AN_KNN))}
    if not err <= AN_CSLS_TOL:
        fails.append(f"CSLS card vs CPU: max error {err}")

    out["hand_kernel_launches"] = {"chol_inv_panel": H.launches, **HM.launches}
    if H.launches or any(HM.launches.values()):
        fails.append(f"a hand kernel ran on the analyses' path: {out['hand_kernel_launches']}")
    if fails:
        raise AssertionError(f"analyses: {'; '.join(fails)}: {out}")
    return out


def imagebind_flops(cfg) -> tuple:
    """(vision, text) FLOPs of one stimulus: 24 d^2 a token and layer (q, k,
    v, out: 8 d^2; the 4x MLP: 16 d^2) plus 4 L^2 d a layer of attention
    (q k^T and the weighted sum), the patch stem and the heads."""
    def tower(tokens, d, layers):
        return layers * (24 * tokens * d * d + 4 * tokens * tokens * d)

    vision = (tower(cfg.n_patches + 1, cfg.vision_embed_dim, cfg.vision_layers)
              + 2 * cfg.n_patches * cfg.patch_dim * cfg.vision_embed_dim
              + 2 * cfg.vision_embed_dim * cfg.out_embed_dim)
    text = (tower(cfg.context_length, cfg.text_embed_dim, cfg.text_layers)
            + 2 * cfg.text_embed_dim * cfg.out_embed_dim)
    return vision, text


def gabor_error_scale(imgs, bank):
    """[B, 2 n_k] float32 error scale of the Gabor features: for a mean,
    S = mean |img| x sum |k| (the mean over pixels of sum |img k| of a
    circular conv), for a variance S^2."""
    import torch

    s = (imgs.abs().double().mean(dim=(1, 2))[:, None]
         * torch.as_tensor(bank, dtype=torch.float64, device=imgs.device).abs().sum(dim=(1, 2)))
    return torch.stack([s, s * s], dim=-1).reshape(len(s), -1)


def moten_error_scale(imgs, sin_bank, cos_bank):
    """[B, n_channels] float32 error scale of the energies: sum |img| x
    max(|sin|, |cos|) over the pixels."""
    import numpy as np
    import torch

    filt = torch.as_tensor(np.maximum(np.abs(sin_bank), np.abs(cos_bank)), dtype=torch.float64,
                           device=imgs.device).reshape(len(sin_bank), -1)
    return imgs.abs().double().reshape(len(imgs), -1) @ filt.T


class BatchesOf:
    """The harness's dataset protocol (``len``, ``batches``) over seeded
    card tensors: ids, token ids as captions, pixels as images."""

    def __init__(self, ids, tokens, pixels):
        self.ids, self.tokens, self.pixels = ids, tokens, pixels

    def __len__(self):
        return len(self.ids)

    def batches(self, batch_size: int, mode: str = "both"):
        for start in range(0, len(self.ids), batch_size):
            stop = start + batch_size
            yield self.ids[start:stop], self.tokens[start:stop], self.pixels[start:stop]


def phase_extract() -> dict:
    """Feature extraction on the card: the random-imagebind control at
    ImageBind-Huge's full width (its weights held to numpy threefry, its
    forward to float64), the extraction harness and its pickle, the Gabor and
    motion-energy banks."""
    import copy

    import numpy as np
    import torch

    from multimodal_decoding_tpu_torch.config import LANG_CLS_FEAT_KEY, VISION_CLS_FEAT_KEY
    from multimodal_decoding_tpu_torch.data.features import _load_feature_pickle
    from multimodal_decoding_tpu_torch.extraction import extractors as EX
    from multimodal_decoding_tpu_torch.extraction import gabor as G
    from multimodal_decoding_tpu_torch.extraction import harness as HA
    from multimodal_decoding_tpu_torch.extraction import imagebind as IB
    from multimodal_decoding_tpu_torch.extraction import motion_energy as ME
    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H
    from multimodal_decoding_tpu_torch.utils import threefry as T
    from multimodal_decoding_tpu_torch.utils.profiling import StageTimer

    out, fails, timer = {}, [], StageTimer()
    H.reset_launches()
    HM.reset_launches()
    gen = torch.Generator(device=DEVICE).manual_seed(EX_SEED)
    rng = np.random.RandomState(EX_SEED)

    # (1) the control network, built through the registry, its weights sampled
    torch.cuda.reset_peak_memory_stats()
    with timer.stage("init"):
        model, cfg, _ = EX.build_extractor("random-imagebind", pretrained=False, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    kv, kt, _ = T.split(T.prng_key(EX_SEED), 3)
    kvs, kts = T.split(kv, cfg.vision_layers + 3), T.split(kt, cfg.text_layers + 2)
    d_v, last = cfg.vision_embed_dim, cfg.vision_layers - 1
    sampled = {"vision.patch_w": (kvs[0], cfg.patch_dim ** -0.5),
               "text.token_embed": (kts[0], 0.02),
               f"vision.blocks.{last}.mlp.fc1.weight": (T.split(kvs[2 + last], 4)[2], d_v ** -0.5)}
    weights, unequal, checked = model.state_dict(), 0, 0
    for name, (key, scale) in sampled.items():
        flat = weights[name].reshape(-1)
        start = int(rng.randint(0, flat.numel() - EX_SAMPLE))
        ref = T.normal_flat(key, start, start + EX_SAMPLE) * np.float32(scale)
        got = flat[start:start + EX_SAMPLE].cpu().numpy()
        unequal += int((got.view(np.int32) != ref.view(np.int32)).sum())
        checked += EX_SAMPLE
    out["control"] = {"init_s": timer.stages["init"], "parameters": n_params,
                      "weight_gb": sum(p.numel() * p.element_size()
                                       for p in model.parameters()) / 1e9,
                      "sampled_weights": checked, "unequal_to_numpy_threefry": unequal,
                      "init_peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
    if unequal:
        fails.append(f"{unequal} of {checked} sampled weights differ from numpy threefry")

    # (2) seeded inputs in the host preprocessing's layout, the forward timed
    def inputs(n):
        px = torch.rand((n, 3, cfg.image_size, cfg.image_size), generator=gen, device=DEVICE)
        mean = torch.tensor(IB.IMAGE_MEAN, device=DEVICE)[:, None, None]
        std = torch.tensor(IB.IMAGE_STD, device=DEVICE)[:, None, None]
        tokens = IB.clip_tokenize(["" for _ in range(n)], cfg, tokenizer=lambda texts: [
            rng.randint(0, IB.SOT_TOKEN, rng.randint(5, 41)).tolist() for _ in texts])
        return torch.as_tensor(tokens, device=DEVICE), (px - mean) / std

    vision_flops, text_flops = imagebind_flops(cfg)
    weight_bytes = out["control"]["weight_gb"] * 1e9
    forward = {}
    for b in EX_BATCHES:
        ids, px = inputs(b)
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode(), timer.stage(f"forward_{b}"):
            ms = cuda_time_ms(lambda: IB.imagebind_embed(model, cfg, ids, px),
                              reps=10 if b <= 16 else 3, warmup=2 if b <= 16 else 1)
        flops = b * (vision_flops + text_flops)
        bound_ms = max(flops / FP32_FLOP_PER_S, weight_bytes / HBM_BYTES_PER_S) * 1e3
        forward[b] = {"ms_per_batch": ms, "stimuli_per_s": b / ms * 1e3,
                      "ms_per_stimulus": ms / b, "bound_ms": bound_ms,
                      "bound_by": "operations" if flops / FP32_FLOP_PER_S
                      >= weight_bytes / HBM_BYTES_PER_S else "bytes",
                      "bound_share": bound_ms / ms, "tflops_per_s": flops / ms / 1e9,
                      "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["forward"] = forward
    out["gflop_per_stimulus"] = {"vision": vision_flops / 1e9, "text": text_flops / 1e9}

    # (3) the same modules in float64 on the card, batch 2
    ids, px = inputs(EX_F64_BATCH)
    with torch.inference_mode(), timer.stage("float64_check"):
        text32, vision32 = IB.imagebind_embed(model, cfg, ids, px)
        model64 = copy.deepcopy(model).double()
        text64, vision64 = IB.imagebind_embed(model64, cfg, ids, px.double())
        scale = float(model.text.log_logit_scale.exp().clamp(max=IB.MAX_LOGIT_SCALE))
        dv = float((vision32.double() - vision64).abs().max())
        dt = float((text32.double() - text64).abs().max())
        del model64
    torch.cuda.empty_cache()
    out["float64"] = {"batch": EX_F64_BATCH, "vision_max_abs_delta": dv,
                      "text_max_abs_delta": dt, "logit_scale": scale}
    if not (dv <= EX_EMBED_TOL and dt <= EX_EMBED_TOL * scale):
        fails.append(f"float32 vs float64 embeds: vision {dv}, text {dt} (scale {scale})")

    # (4) the extraction harness over seeded batches, read back by the data layer
    n = EX_HARNESS_BATCHES * EX_BATCHES[0]
    ids, px = inputs(n)
    stim_ids = list(range(1000, 1000 + n))
    emitted = {}

    def extract(batch_ids, tokens, pixels):
        with torch.inference_mode():
            t, v = IB.imagebind_embed(model, cfg, tokens, pixels)
        feats = {LANG_CLS_FEAT_KEY: t.cpu().numpy(), VISION_CLS_FEAT_KEY: v.cpu().numpy()}
        for i, sid in enumerate(batch_ids):
            emitted[sid] = {k: f[i] for k, f in feats.items()}
        return feats

    path = os.path.join(WS.dir("extract"), "random-imagebind.p")
    with timer.stage("harness"):
        HA.run_extraction(extract, "random-imagebind", BatchesOf(stim_ids, ids, px),
                          batch_size=EX_BATCHES[0], out_path=path, progress=False)
    read = _load_feature_pickle(path)
    rows_equal = sorted(read) == stim_ids and all(
        read[s].keys() == {LANG_CLS_FEAT_KEY, VISION_CLS_FEAT_KEY}
        and all(r.dtype == np.float32 and r.shape == (cfg.out_embed_dim,)
                and np.array_equal(r, emitted[s][k]) for k, r in read[s].items())
        for s in stim_ids)
    with torch.inference_mode():
        again = IB.imagebind_embed(model, cfg, ids[:EX_BATCHES[0]], px[:EX_BATCHES[0]])[1]
    rerun = float(np.abs(again.cpu().numpy() - np.stack(
        [read[s][VISION_CLS_FEAT_KEY] for s in stim_ids[:EX_BATCHES[0]]])).max())
    out["harness"] = {"stimuli": n, "batches": EX_HARNESS_BATCHES, "seconds": timer.stages["harness"],
                      "rows_equal": rows_equal, "rerun_max_abs_delta": rerun}
    if not rows_equal or rerun > 1e-6:
        fails.append(f"harness pickle: rows equal {rows_equal}, rerun delta {rerun}")
    del model
    torch.cuda.empty_cache()

    # (5) the Gabor bank on the CLI's batch, against float64 and scipy
    from scipy import ndimage

    imgs = torch.rand((EX_BANK_N, EX_GABOR_PX, EX_GABOR_PX), generator=gen, device=DEVICE) * 255
    bank = G._padded_bank(G.make_gabor_filterbank())
    torch.cuda.reset_peak_memory_stats()
    with timer.stage("gabor"):
        ms = cuda_time_ms(lambda: G.compute_gabor_feats_batch(imgs, bank), reps=3, warmup=1)
        feats = G.compute_gabor_feats_batch(imgs, bank)
    peak = torch.cuda.max_memory_allocated() / 1e9
    with timer.stage("gabor_float64"):
        ref = torch.cat([G.compute_gabor_feats_batch(imgs[i:i + 25].double(), bank)
                         for i in range(0, EX_BANK_N, 25)])
    err = (feats.double() - ref).abs()
    scaled = float((err / gabor_error_scale(imgs, bank)).max())
    col_rel = (err / ref.abs().max(dim=0).values).reshape(EX_BANK_N, -1, 2).amax(dim=(0, 1))
    k, n_img = EX_SCIPY[1], EX_SCIPY[0]
    small = G.compute_gabor_feats_batch(imgs[:n_img], G._padded_bank(
        G.make_gabor_filterbank()[:k])).cpu().numpy()
    host = imgs[:n_img].cpu().double().numpy()
    scipy_ref = np.array([[v for kern in G.make_gabor_filterbank()[:k]
                           for f in [ndimage.convolve(host[b], kern, mode="wrap")]
                           for v in (f.mean(), f.var())] for b in range(n_img)])
    scipy_ok = bool(np.allclose(small, scipy_ref, rtol=2e-3, atol=2e-2))
    taps = bank.shape[-1] ** 2
    flops = 2 * taps * EX_GABOR_PX ** 2 * bank.shape[0] * EX_BANK_N
    out["gabor"] = {
        "images": EX_BANK_N, "px": EX_GABOR_PX, "kernels": bank.shape[0], "taps": taps,
        "ms_per_batch": ms, "conv_output_gb": EX_BANK_N * bank.shape[0] * EX_GABOR_PX ** 2 * 4 / 1e9,
        "gflop_per_image": flops / EX_BANK_N / 1e9, "bound_ms": flops / FP32_FLOP_PER_S * 1e3,
        "bound_by": "operations", "tflops_per_s": flops / ms / 1e9, "peak_device_gb": peak,
        "float64_s": timer.stages["gabor_float64"], "max_err_over_error_scale": scaled,
        "max_rel_to_column_max": {"mean": float(col_rel[0]), "var": float(col_rel[1])},
        "scipy_within_rtol_2e-3_atol_2e-2": scipy_ok,
        "scipy_max_abs_delta": float(np.abs(small - scipy_ref).max())}
    if not (scaled <= EX_BANK_TOL and scipy_ok and torch.isfinite(feats).all()):
        fails.append(f"gabor: {scaled} of the error scale, scipy {scipy_ok}")
    del imgs, feats, ref, err
    torch.cuda.empty_cache()

    # (6) motion energy at the CLI's 96 px, against float64
    imgs = torch.rand((EX_BANK_N, EX_MOTEN_PX, EX_MOTEN_PX), generator=gen, device=DEVICE) * 255
    sin_b, cos_b, channels = ME.build_spatial_pyramid(EX_MOTEN_PX)
    host_ms = cuda_time_ms(lambda: ME.motion_energy_features(imgs, sin_b, cos_b), reps=10)
    banks = [torch.as_tensor(b, device=DEVICE) for b in (sin_b, cos_b)]  # as the extractor holds them
    with timer.stage("moten"):
        ms = cuda_time_ms(lambda: ME.motion_energy_features(imgs, *banks), reps=10)
        feats = ME.motion_energy_features(imgs, *banks)
    ref = ME.motion_energy_features(imgs.double(), sin_b, cos_b)
    err = (feats.double() - ref).abs()
    scaled = float((err / moten_error_scale(imgs, sin_b, cos_b)).max())
    flops = 2 * 2 * EX_BANK_N * EX_MOTEN_PX ** 2 * len(channels)
    moved = (2 * len(channels) + EX_BANK_N) * EX_MOTEN_PX ** 2 * 4 + EX_BANK_N * len(channels) * 4
    out["moten"] = {"images": EX_BANK_N, "px": EX_MOTEN_PX, "channels": len(channels),
                    "ms_per_batch": ms, "ms_per_batch_banks_from_host": host_ms,
                    "bound_ms": max(flops / FP32_FLOP_PER_S, moved / HBM_BYTES_PER_S) * 1e3,
                    "bound_by": "operations" if flops / FP32_FLOP_PER_S
                    >= moved / HBM_BYTES_PER_S else "bytes",
                    "max_err_over_error_scale": scaled,
                    "max_rel_err": float((err / ref.abs()).max())}
    if len(channels) != 1361 or not scaled <= EX_BANK_TOL:
        fails.append(f"motion energy: {len(channels)} channels, {scaled} of the error scale")

    out["stage_s"] = dict(timer.stages)
    out["hand_kernel_launches"] = {"chol_inv_panel": H.launches, **HM.launches}
    if H.launches or any(HM.launches.values()):
        fails.append(f"a hand kernel ran on the extraction path: {out['hand_kernel_launches']}")
    if fails:
        raise AssertionError(f"extract: {'; '.join(fails)}: {out}")
    return out


def spelled_alike(out: str, paths: dict) -> list:
    """An example's printed lines with ``paths`` ({path: placeholder}) and
    temporary directory names replaced, and the device and timings the
    library prints dropped: what a run on another device must print alike."""
    import re

    for path, placeholder in paths.items():
        out = out.replace(path, placeholder)
    out = re.sub(r"(mmd_demo_|mmd_roi_)\w+", r"\1<tmp>", out)
    out = re.sub(r" \| DEVICE: \S+", "", out)
    out = re.sub(r"Searchlight time: \d+s \(\d+ vertices/s\)", "Searchlight time: <t>", out)
    out = re.sub(r"Elapsed time: \d+s", "Elapsed time: <t>", out)
    return out.splitlines()


def phase_examples() -> dict:
    """The port's examples on the card (phase examples), each against a
    --device cpu run of the port in this phase."""
    import contextlib
    import importlib.util
    import io
    import re
    import tempfile

    import torch

    from multimodal_decoding_tpu_torch.examples import (
        full_pipeline,
        model_comparison,
        nearest_neighbor_ranking,
        roi_decoding,
    )
    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H

    root = WS.dir("examples")
    figure = importlib.util.find_spec("matplotlib") is not None

    def pipeline(device):
        wd = os.path.join(tempfile.tempdir, "full_pipeline")
        result = full_pipeline.pipeline(wd, 40, 6, device)
        if figure:  # host matplotlib, which the card machine may lack
            full_pipeline.figure(wd, *result)

    def ranking(device):
        # both devices rank the predictions of the card's model_comparison run
        found = [os.path.join(base, f) for base, _, fs in os.walk(os.path.join(root, "card"))
                 for f in fs if f == "results.p" and "mmd_demo_" in base]
        nearest_neighbor_ranking.main([found[0], "--device", device])

    examples = {"full_pipeline": pipeline,
                "model_comparison": lambda d: model_comparison.main(["--device", d]),
                "roi_decoding": lambda d: roi_decoding.main(["--device", d]),
                "nearest_neighbor_ranking": ranking}
    runs = {}
    saved = tempfile.tempdir
    try:
        for run, device in (("card", DEVICE), ("cpu", "cpu")):
            tempfile.tempdir = os.path.join(root, run)
            os.makedirs(tempfile.tempdir)
            for name, fn in examples.items():
                H.reset_launches()
                HM.reset_launches()
                log = io.StringIO()
                t0 = time.time()
                with contextlib.redirect_stdout(log):
                    fn(device)
                torch.cuda.synchronize()
                runs[name, run] = {"seconds": time.time() - t0, "launches": H.launches,
                                   "streamed": sum(HM.launches.values()),
                                   "lines": spelled_alike(log.getvalue(),
                                                          {tempfile.tempdir: "<root>"})}
    finally:
        tempfile.tempdir = saved

    out, fails = {"figure_step": "run" if figure else "skipped: no matplotlib here"}, []
    for name in examples:
        card, cpu = runs[name, "card"], runs[name, "cpu"]
        numbers = re.findall(r"\d+\.\d+", "\n".join(card["lines"]))
        differ = [(a, b) for a, b in zip(card["lines"], cpu["lines"]) if a != b]
        out[name] = {"card_s": card["seconds"], "cpu_s": cpu["seconds"],
                     "chol_inv_panel_launches": card["launches"], "lines": len(card["lines"]),
                     "numbers_compared": len(numbers), "last_line": card["lines"][-1]}
        if len(card["lines"]) != len(cpu["lines"]) or differ:
            fails.append(f"{name}: card and CPU print differently, first {differ[:3]}")
        if cpu["launches"] or card["streamed"] or cpu["streamed"]:
            fails.append(f"{name}: kernels launched off the card path: {cpu}, {card}")
        if (card["launches"] > 0) != (name != "nearest_neighbor_ranking"):
            fails.append(f"{name}: {card['launches']} chol_inv_panel launches on the card")
    if fails:
        raise AssertionError(f"examples: {'; '.join(fails)}: {out}")
    return out


def kernels_line(results: dict) -> dict:
    """The {"kernels": [...]} summary: each kernel's launches on its main path
    (the CLI for chol_inv_panel, its scorer's run for the streamed ones) and
    its measurements from the kernel phase."""
    keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    shapes = results.get("kernel", {}).get("shapes", [{}])
    dist = results.get("dist", {})
    radius = results.get("radius", {})
    main_shape = shapes[0]
    wb_keys = (*keys, "max_rel_err", "library_ratio")
    kernels = [{
        "name": "chol_inv_panel", "route": "cuda",
        "source": "multimodal_decoding_tpu_torch/csrc/chol_inv_panel.cu",
        "replaces": "multimodal_decoding_tpu/ops/pallas_solvers.py:133",
        "launches": results.get("cli", {}).get("launches"),
        "launches_by_path": {
            "searchlight_cli": results.get("cli", {}).get("launches"),
            "whole_brain": results.get("wb", {}).get("launches"),
            "whole_brain_cli": results.get("wb_cli", {}).get("launches"),
            "study": results.get("study", {}).get("launches"),
            "streamed_ingestion": results.get("ingest", {}).get("launches"),
            "vertex_sharded_searchlight": dist.get("searchlight", {}).get("launches"),
            "feature_sharded_whole_brain_cli": dist.get("whole_brain_cli", {}).get("launches"),
            "entry": dist.get("entry", {}).get("launches"),
            "radius_blocks": radius.get("blocks", {}).get("chol_inv_panel", {}).get("launches"),
            "radius_cli": radius.get("cli", {}).get("launches"),
            "examples": sum(v.get("chol_inv_panel_launches", 0)
                            for v in results.get("examples", {}).values()
                            if isinstance(v, dict)) or None},
        **{k: main_shape.get(k) for k in keys}, "max_rel_err": main_shape.get("max_rel_err"),
        "library_ratio": main_shape.get("library_ratio"),
        "whole_brain_shapes": [{k: m.get(k) for k in wb_keys} for m in shapes
                               if m.get("shape", [None])[0] != B],
        "radius_shapes": [{k: m.get(k) for k in wb_keys} for m in shapes
                          if tuple(m.get("shape", [None])[:2]) in RADIUS_BASE_SHAPES],
    }]
    scorer_of = {kernel: scorer for scorer, kernel in STREAMED_SCORERS.items() if kernel}
    precision = results.get("precision", {})
    for name, replaces in STREAMED:
        measured = results.get("kernel", {}).get(name, {})
        run = results.get("scorers", {}).get(scorer_of[name], {})
        kernels.append({
            "name": name, "route": "cuda",
            "source": "multimodal_decoding_tpu_torch/csrc/streamed_count.cu",
            "replaces": replaces, "launches": run.get("launches", {}).get(name),
            "precision": "highest",
            **{k: measured.get(k) for k in keys}, "library_ratio": measured.get("library_ratio"),
        })
        # the tensor-core variants: launches from the bf16 selection run of
        # their scorer at that precision, times with the operands that run
        # hands them (a bf16 first operand; for streamed_acc_from_factors Z's
        # bf16 planes), and with a float32 first operand (and Z) beside them
        factors = name == "streamed_acc_from_factors"
        for prec in TC_PRECISIONS:
            variant = precision.get("kernels", {}).get(f"{name}:{prec}", {})
            main = variant.get("bfloat16_z_planes" if factors else "bfloat16", {})
            sel = precision.get("selection", {}).get(f"{scorer_of[name]}:{prec}", {})
            timed = ("ms", "max_abs_err", "bound_ms")
            kernels.append({
                "name": f"{name}:{prec}", "route": "cuda",
                "source": "multimodal_decoding_tpu_torch/csrc/streamed_count.cu",
                "replaces": replaces, "precision": prec,
                "launches": sel.get("launches", {}).get(name, {}).get(prec),
                "first_operand": "bfloat16",
                **({"z": "bf16 planes from factor_planes",
                    "float32_z": {k: variant.get("bfloat16", {}).get(k) for k in timed}}
                   if factors else {}),
                **{k: main.get(k) for k in keys if k != "shape"},
                "library_ratio": main.get("library_ratio"),
                "float32_first_operand": {k: variant.get("float32", {}).get(k) for k in timed},
            })
    return {"kernels": kernels}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES + EXTRA_PHASES} "
                         f"(default: {','.join(PHASES)})")
    ap.add_argument("--scorer", default="xla", choices=("xla", *STREAMED_SCORERS),
                    help="CV fold scorer of the profile phase (default: xla)")
    ap.add_argument("--precision", default="highest", choices=("highest", *TC_PRECISIONS),
                    help="CV precision of the profile phase; default and high store the "
                         "selection in bf16 (default: highest)")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to prove", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import multimodal_decoding_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2

    global WS
    results = {}
    with tempfile.TemporaryDirectory(prefix="mmd_chip_smoke_") as root:
        WS = Workspace(root)
        for name in phases:
            t0 = time.time()
            out = {"build": phase_build, "kernel": phase_kernel, "gate": phase_gate,
                   "scorers": phase_scorers, "cli": phase_cli, "wb_gate": phase_wb_gate,
                   "precision": phase_precision,
                   "wb": phase_wb, "wb_cli": phase_wb_cli, "stats": phase_stats,
                   "study": phase_study, "ingest": phase_ingest, "dist": phase_dist,
                   "analyses": phase_analyses, "extract": phase_extract,
                   "radius": phase_radius, "examples": phase_examples,
                   "flips": phase_flips,
                   "wb_profile": phase_wb_profile,
                   "profile": lambda: phase_profile(args.scorer, args.precision)}[name]()
            results[name] = out
            emit({"phase": name, "seconds": time.time() - t0, **out})

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    emit(kernels_line(results))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
