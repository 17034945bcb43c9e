"""State carried between the JAX package and the port.

The system learns no weights that outlive a run: what the two packages share
is a block step's inputs and the ridge weights ``W [B, K, D]`` that
``fit_block_cv`` returns in both, and the whole-brain decoder's state: the
gram and query kernels of its ``GramCache`` and the dual coefficients of
``ridge_cv_dual``.  ``block_inputs_from_numpy`` and
``whole_brain_state_from_numpy`` turn the JAX package's numpy arrays into the
port's tensors, with the same dtypes and layouts, on one device (``cuda``
unless the caller names one); ``gram_cache_from_numpy`` starts the port's
decoder from a JAX ``GramCache``; ``to_numpy`` brings outputs back.

Feature extraction has weights: ``imagebind_from_jax_params`` turns the JAX
package's ImageBind pytree into the port's modules, and
``hf_state_dict_from_flax`` turns a flattened HF Flax parameter dict into
the torch ``state_dict`` of the same HF model.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_decoding_tpu_torch.decoding.whole_brain import GramCache
from multimodal_decoding_tpu_torch.device import as_float32, resolve_device
from multimodal_decoding_tpu_torch.extraction import imagebind as IB

_DTYPES = {
    "X_all": torch.float32,       # [N_all, V] train, test, imagery rows
    "Y_train": torch.float32,     # [N, D]
    "Y_test": torch.float32,      # [n_test, D]
    "Y_imag": torch.float32,      # [n_imag, D]
    "idx": torch.int32,           # [B, K] neighbour indices
    "mask": torch.bool,           # [B, K] or None
    "alphas": torch.float32,      # [A]
    "shuffles": torch.int32,      # [P, n_test]
    "derangements": torch.int32,  # [B, P] imagery derangement choice
}


def block_inputs_from_numpy(device=None, **arrays) -> dict:
    """Numpy block-step inputs -> tensors on ``device``, keyed as given.

    Accepted keys: ``X_all, Y_train, Y_test, Y_imag, idx, mask, alphas,
    shuffles, derangements``; a ``None`` value stays ``None``.  ``device``
    defaults to ``cuda`` and raises without a GPU (``device.resolve_device``).
    """
    unknown = set(arrays) - set(_DTYPES)
    if unknown:
        raise ValueError(f"unknown block inputs: {sorted(unknown)}")
    device = resolve_device(device)
    return {
        name: None if a is None
        else torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=_DTYPES[name])
        for name, a in arrays.items()
    }


_WB_STATE = ("K", "K_test", "K_imag", "dual_coef")  # all float32


def whole_brain_state_from_numpy(device=None, **arrays) -> dict:
    """Numpy whole-brain state -> float32 tensors on ``device``, keyed as given.

    Accepted keys: ``K [N, N]``, ``K_test [n_test, N]``, ``K_imag [n_imag, N]``
    (a JAX ``GramCache``'s kernels) and ``dual_coef [N, D]`` (what JAX
    ``ridge_cv_dual`` returns).
    """
    unknown = set(arrays) - set(_WB_STATE)
    if unknown:
        raise ValueError(f"unknown whole-brain state: {sorted(unknown)}")
    device = resolve_device(device)
    return {name: as_float32(a, device) for name, a in arrays.items()}


def gram_cache_from_numpy(K, K_test, K_imag, device=None):
    """The port's ``GramCache`` around a JAX ``GramCache``'s kernels."""
    state = whole_brain_state_from_numpy(device, K=K, K_test=K_test, K_imag=K_imag)
    return GramCache.from_kernels(state["K"], state["K_test"], state["K_imag"])


def to_numpy(out):
    """Tensors (or dicts/tuples of them) -> numpy, for comparison with JAX outputs."""
    if isinstance(out, dict):
        return {k: to_numpy(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(to_numpy(v) for v in out)
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return out


def imagebind_from_jax_params(params: dict, cfg: IB.ImageBindConfig, device=None) -> IB.ImageBind:
    """The JAX package's ImageBind pytree (``init_params`` /
    ``params_from_torch_state_dict``; leaves as numpy arrays) -> the port's
    ``ImageBind`` on ``device``, through the official checkpoint's key names."""
    def ln(p):
        return np.asarray(p["scale"]), np.asarray(p["bias"])

    v, t = params["vision"], params["text"]
    sd = {
        "modality_preprocessors.vision.cls_token": v["cls_token"],
        "modality_preprocessors.vision.rgbt_stem.proj.1.weight": np.asarray(v["patch_w"]).reshape(
            cfg.vision_embed_dim, 3, cfg.n_frames, cfg.patch_size, cfg.patch_size),
        "modality_preprocessors.vision.pos_embedding_helper.pos_embed": v["pos_embed"],
        "modality_preprocessors.text.token_embedding.weight": t["token_embed"],
        "modality_preprocessors.text.pos_embed": t["pos_embed"],
        "modality_heads.vision.2.weight": v["head_w"],
        "modality_heads.text.proj.1.weight": t["head_w"],
        "modality_postprocessors.text.1.log_logit_scale": t["log_logit_scale"],
    }
    for prefix, p in (("modality_trunks.vision.pre_transformer_layer.0", v["pre_ln"]),
                      ("modality_heads.vision.0", v["head_ln"]),
                      ("modality_heads.text.proj.0", t["head_ln"])):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = ln(p)
    for tower, blocks in (("vision", v["blocks"]), ("text", t["blocks"])):
        for i, b in enumerate(blocks):
            p = f"modality_trunks.{tower}.blocks.{i}"
            for name in ("norm_1", "norm_2"):
                sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = ln(b[name])
            sd[f"{p}.attn.in_proj_weight"] = b["in_proj_w"]
            sd[f"{p}.attn.in_proj_bias"] = b["in_proj_b"]
            sd[f"{p}.attn.out_proj.weight"] = b["out_proj_w"]
            sd[f"{p}.attn.out_proj.bias"] = b["out_proj_b"]
            sd[f"{p}.mlp.fc1.weight"] = b["fc1_w"]
            sd[f"{p}.mlp.fc1.bias"] = b["fc1_b"]
            sd[f"{p}.mlp.fc2.weight"] = b["fc2_w"]
            sd[f"{p}.mlp.fc2.bias"] = b["fc2_b"]
    return IB.params_from_torch_state_dict(
        {k: np.asarray(a, np.float32) for k, a in sd.items()}, cfg, device)


_FLAX_HEADERS = ("params", "batch_stats")


def hf_state_dict_from_flax(flat_params: dict) -> dict:
    """A flattened HF Flax parameter dict (``{"a/b/kernel": array}``, as
    ``flax.traverse_util.flatten_dict(model.params, sep="/")`` gives) -> the
    torch ``state_dict`` of the same HF model, for ``load_state_dict(...,
    strict=True)``.

    The renaming rules of transformers' ``load_flax_weights_in_pytorch_model``
    (modeling_flax_pytorch_utils.py), without flax or jax: a 4-D ``kernel``
    (a conv, HWIO) is transposed (3, 2, 0, 1) to OIHW; a 2-D ``kernel`` (a
    dense layer, and GPT-2's Conv1D, whose Flax kernel is [out, in]) is
    transposed; ``scale`` and ``embedding`` become ``weight``; batch-stats
    ``mean``/``var`` become ``running_mean``/``running_var``, beside a zero
    ``num_batches_tracked`` (what a torch BatchNorm holds and Flax does not).
    A leading ``params``/``batch_stats`` collection name is dropped.
    """
    sd = {}
    for key, value in flat_params.items():
        parts = key.split("/")
        if parts[0] in _FLAX_HEADERS:
            parts = parts[1:]
        a = np.asarray(value, dtype=np.float32)
        leaf = parts[-1]
        if leaf == "kernel" and a.ndim == 4:
            parts[-1], a = "weight", a.transpose(3, 2, 0, 1)
        elif leaf == "kernel":
            parts[-1], a = "weight", a.T
        elif leaf in ("scale", "embedding"):
            parts[-1] = "weight"
        elif leaf == "mean":
            parts[-1] = "running_mean"
            sd[".".join(parts[:-1] + ["num_batches_tracked"])] = torch.zeros((), dtype=torch.long)
        elif leaf == "var":
            parts[-1] = "running_var"
        sd[".".join(parts)] = torch.from_numpy(np.array(a))
    return sd
