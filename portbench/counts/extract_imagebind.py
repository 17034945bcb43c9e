"""Least work of one batch of ImageBind-Huge's extraction: every stimulus's
caption through the text tower and its image through the vision tower, in
float32, at the configuration's widths (``configs/<config>.json``).

Operations are the model's products, 2 per multiply-add, as
``torch.utils.flop_counter.FlopCounterMode`` counts them (the attention over
every position, the text's padded context of ``context_length`` included,
as the published model computes it); LayerNorm, softmax, GELU and the adds
are not counted.  Bytes: each float32 weight read once a batch (of the
token embedding only the rows the batch gathers), the pixels and ids in,
the embeddings out.

* ``vision_stem``: the Conv3d stem over the 2-frame patches;
* ``vision_blocks``: per layer and token, the q/k/v, output and MLP
  projections; per layer ``q k^T`` and ``attention @ v`` over all tokens;
* ``vision_head``, ``text_head``: the class token's and the EOT token's
  projection;
* ``text_blocks``: as ``vision_blocks`` over the context;
* ``weights``, ``inputs``, ``outputs``: the bytes.

``terms(cfg, tokens)`` takes one batch's captions' token counts (with SOT
and EOT; the padded context does not depend on them).
"""

from __future__ import annotations


def _blocks(layers: int, n: int, d: int, mlp: int) -> int:
    """Products of ``layers`` pre-norm blocks over ``n`` tokens of width ``d``."""
    projections = 2 * n * d * (3 * d + d + 2 * mlp)
    attention = 2 * 2 * n * n * d
    return layers * (projections + attention)


def _block_params(d: int, mlp: int) -> int:
    return 4 * d * d + 4 * d + 2 * d * mlp + mlp + d + 4 * d


def flops_per_stimulus(cfg: dict) -> dict:
    """{term: operations} of one stimulus."""
    dv, dt, out = cfg["vision_embed_dim"], cfg["text_embed_dim"], cfg["out_embed_dim"]
    patches = (cfg["image_size"] // cfg["patch_size"]) ** 2
    patch_dim = 3 * cfg["n_frames"] * cfg["patch_size"] ** 2
    return {
        "vision_stem": 2 * patches * patch_dim * dv,
        "vision_blocks": _blocks(cfg["vision_layers"], patches + 1, dv, int(dv * cfg["mlp_ratio"])),
        "vision_head": 2 * dv * out,
        "text_blocks": _blocks(cfg["text_layers"], cfg["context_length"], dt,
                               int(dt * cfg["mlp_ratio"])),
        "text_head": 2 * dt * out,
    }


def terms(cfg: dict, tokens: list) -> dict:
    """{name: (flops, bytes)} of one batch of ``len(tokens)`` stimuli."""
    b = len(tokens)
    dv, dt, out = cfg["vision_embed_dim"], cfg["text_embed_dim"], cfg["out_embed_dim"]
    patches = (cfg["image_size"] // cfg["patch_size"]) ** 2
    patch_dim = 3 * cfg["n_frames"] * cfg["patch_size"] ** 2
    L = cfg["context_length"]
    vision_params = (dv * patch_dim + dv + (patches + 1) * dv + 2 * dv
                     + cfg["vision_layers"] * _block_params(dv, int(dv * cfg["mlp_ratio"]))
                     + 2 * dv + out * dv)
    text_params = (L * dt + cfg["text_layers"] * _block_params(dt, int(dt * cfg["mlp_ratio"]))
                   + 2 * dt + out * dt + 1)
    t = {name: (b * f, 0) for name, f in flops_per_stimulus(cfg).items()}
    t["weights"] = (0, 4 * (vision_params + text_params + b * L * dt))
    t["inputs"] = (0, b * (3 * cfg["image_size"] ** 2 * 4 + L * 8))
    t["outputs"] = (0, b * 2 * out * 4)
    return t
