#!/usr/bin/env python3
"""Start-up proof of the PyTorch port (multimodal_decoding_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. build   - compile every kernel of the main path from csrc/ with nvcc.
2. kernel  - each kernel against its plain PyTorch version on the card at the
             main path's shapes: max error, CUDA-event median times of the
             kernel, the plain version and one library yardstick, and the
             least time the card could take (bound).
3. gate    - two runner blocks (B=128) at full width (N=8192 train, 140 test,
             3 imagery, K=750, D=1024, 6 alphas x 5 folds, 100 shuffles),
             once with the shipped "schur-pallas" selection and once with the
             strict Cholesky selection, on a planted signal whose strength
             varies over the sphere: at least 3 distinct alphas selected,
             alpha agreement >= 0.998, CV-score delta <= 1e-5, final-score
             delta <= 1e-4, and 240 kernel launches (2 blocks x 120).
4. cli     - the port's searchlight CLI in-process, on a synthetic subject at
             full width on icosphere(4) (2,562 vertices per hemisphere, the
             only cut from production's 163,842), with --n-neighbors 750,
             the 6-alpha CV and 100 null shuffles; checks the artifacts, the
             planted-signal accuracies and that the kernel ran.

Then it prints the card's name and power limit (nvidia-smi), one
{"kernels": [...]} line, and as its last line
{"ok": true, "device": {"platform": "gpu", ...}}.  Any failed check raises
and the exit code is not 0.  Without a CUDA device, or outside a checkout of
the repository, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "kernel", "gate", "cli")
EXTRA_PHASES = ("profile",)  # run on request: --phases build,profile
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

KERNEL_TOL = 1e-4         # max |kernel - plain| / max |plain|
ALPHA_AGREEMENT_MIN = 0.998
CV_SCORE_DELTA_MAX = 1e-5  # per (vertex, alpha) CV accuracy
SCORE_DELTA_MAX = 1e-4
MIN_DISTINCT_ALPHAS = 3    # the gate must see the selection pick across the grid
ALPHAS = [1e2, 1e3, 1e4, 1e5, 1e6, 1e7]
N_TRAIN, N_TEST, N_IMAG, K, D, B, P = 8192, 140, 3, 750, 1024, 128, 100
LAUNCHES_PER_BLOCK = 120  # 4 base blocks per Schur inverse x 6 alphas x 5 folds


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    times.sort()
    return times[len(times) // 2]


def spd_batch(b: int, pb: int, alpha: float, seed: int):
    """[b, pb, pb] float32 grams of 8192 random rows plus alpha I, on the card."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    X = torch.randn((b, N_TRAIN, pb), generator=gen, device=DEVICE)
    return X.mT @ X + alpha * torch.eye(pb, device=DEVICE)


def phase_build() -> dict:
    from multimodal_decoding_tpu_torch.ops import hopper_solvers

    path = hopper_solvers.build(force=True, verbose=True)
    return {"library": os.path.relpath(path, ROOT)}


def phase_kernel() -> dict:
    import torch

    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H

    shapes = []
    for pb in (188, 187, 64):
        A = spd_batch(B, pb, ALPHAS[0], seed=pb)
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

        ms = cuda_time_ms(lambda: H.chol_inv_panel(A))
        plain_ms = cuda_time_ms(lambda: H.chol_inv_panel_plain(A))
        library_ms = cuda_time_ms(library)
        # chol(A) depends on A's lower triangle only; the full L^-1 is written
        bytes_moved = B * (pb * (pb + 1) // 2 + pb * pb) * 4
        flops = 2.0 / 3.0 * pb ** 3 * B
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / FP32_FLOP_PER_S * 1e3
        shapes.append({
            "shape": [B, pb, pb], "max_abs_err": max_abs, "max_rel_err": max_rel,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        })
    return {"shapes": shapes}


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


def phase_gate() -> dict:
    import numpy as np
    import torch

    from multimodal_decoding_tpu_torch.data.stimuli import create_null_distr_shuffled_indices
    from multimodal_decoding_tpu_torch.decoding import searchlight_engine as E
    from multimodal_decoding_tpu_torch.decoding.searchlight import default_cv_solver
    from multimodal_decoding_tpu_torch.io.surface import icosphere, knn_adjacency
    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H
    from multimodal_decoding_tpu_torch.parallel.searchlight_runner import run_searchlight

    cv_solver = default_cv_solver(DEVICE)
    if cv_solver != "schur-pallas":
        raise AssertionError(f"CUDA default CV solver is {cv_solver!r}, not 'schur-pallas'")
    coords = icosphere(4).coordinates
    adjacency = knn_adjacency(coords, K)[0][:2 * B]
    problem = planted_problem(coords, seed=0)
    shuffles = np.stack(create_null_distr_shuffled_indices(P)).astype(np.int32)
    stim_types = np.array(["caption"] * (N_TEST // 2) + ["image"] * (N_TEST // 2))

    def run(solver, scorer):
        return run_searchlight(*problem, adjacency, stim_types, alphas_cv=ALPHAS,
                               shuffles=shuffles,
                               block_size=B, device=DEVICE, cv_solver=solver,
                               cv_scorer=scorer, progress=False)

    H.reset_launches()
    fast, fast_aux = run(cv_solver, "xla")
    launches = H.launches
    strict, strict_aux = run(None, "strict")
    agreement = float(np.mean(fast_aux["best_alpha"] == strict_aux["best_alpha"]))
    delta = max(float(np.max(np.abs(fast[m] - strict[m]))) for m in strict)
    null_delta = max(float(np.max(np.abs(fast_aux["null_scores"][m]
                                         - strict_aux["null_scores"][m])))
                     for m in strict_aux["null_scores"])

    # the CV score grids themselves: the scale-invariant and cosine scorers
    # rank identically, so the two selection paths differ only by rounding
    X_train = torch.as_tensor(problem[0], device=DEVICE)
    Y_train = torch.as_tensor(problem[3], device=DEVICE)
    alphas = torch.as_tensor(ALPHAS, dtype=torch.float32, device=DEVICE)
    cv_delta = 0.0
    for b in range(2):
        idx = torch.as_tensor(adjacency[b * B:(b + 1) * B], device=DEVICE)
        Xg = E.gather_patches(X_train, idx)
        cv_fast = E.fit_block_cv(Xg, Y_train, alphas, cv_solver=cv_solver, cv_scorer="xla")[2]
        cv_strict = E.fit_block_cv(Xg, Y_train, alphas, cv_scorer="strict")[2]
        cv_delta = max(cv_delta, float((cv_fast - cv_strict).abs().max()))
        del Xg

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
    return out


def phase_profile() -> dict:
    """Where one main-path block step's device time goes (torch.profiler)."""
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

    def step():
        return E.searchlight_block_cv_with_null(
            X_all, Ytr, Yte, Yim, idx, None, alphas, shuffles, der, layout=layout,
            n_train=N_TRAIN, n_test=N_TEST, cv_solver="schur-pallas")

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

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side rows only (kernels, copies): operator rows repeat their time
    kernels = sorted(((e.key, dev_us(e), e.count) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0),
                     key=lambda r: -r[1])
    device_ms = sum(r[1] for r in kernels) / 1e3
    return {"block_wall_ms": sorted(walls)[1] * 1e3, "profiled_wall_ms": prof_wall * 1e3,
            "device_ms": device_ms, "device_busy_share": device_ms / (prof_wall * 1e3),
            "top": [{"name": k[:90], "ms": us / 1e3, "calls": c} for k, us, c in kernels[:14]]}


def phase_cli() -> dict:
    import numpy as np

    from multimodal_decoding_tpu_torch import config
    from multimodal_decoding_tpu_torch.cli import run_searchlight as cli
    from multimodal_decoding_tpu_torch.data.features import _load_feature_pickle
    from multimodal_decoding_tpu_torch.data.synthetic import make_synthetic_dataset
    from multimodal_decoding_tpu_torch.io import artifacts
    from multimodal_decoding_tpu_torch.io.surface import icosphere, write_freesurfer_geometry
    from multimodal_decoding_tpu_torch.ops import hopper_solvers as H
    from multimodal_decoding_tpu_torch.ops import metrics as M

    with tempfile.TemporaryDirectory(prefix="mmd_chip_smoke_") as root:
        t0 = time.time()
        mesh = icosphere(4)
        info = make_synthetic_dataset(root, n_train=N_TRAIN, n_vertices=mesh.n_vertices,
                                      latent_dim=D, model="imagebind", hemis=["left"])
        config.FMRI_STIM_INFO_DIR = info["stim_info_dir"]
        config.LATENT_FEATURES_DIR = info["features_dir"]
        config.BETAS_CACHE_DIR = os.path.join(root, "betas_cache")
        _load_feature_pickle.cache_clear()
        mesh_dir = os.path.join(root, "surfaces", "fsaverage7")
        os.makedirs(mesh_dir)
        write_freesurfer_geometry(os.path.join(mesh_dir, "lh.inflated"), mesh)
        dataset_s = time.time() - t0

        out_dir = os.path.join(root, "sl")
        argv = ["--betas-dir", os.path.join(info["betas_dir"], "surface"),
                "--subjects", "sub-01", "--model", "imagebind", "--hemis", "left",
                "--n-neighbors", str(K), "--l2-alphas", *[str(a) for a in ALPHAS],
                "--create-null-distr", "--n-permutations-per-subject", str(P),
                "--block-size", str(B), "--mesh-dir", os.path.join(root, "surfaces"),
                "--out-dir", out_dir, "--device", DEVICE]
        H.reset_launches()
        t1 = time.time()
        paths = cli.main(argv)
        cli_s = time.time() - t1
        launches = H.launches

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
        return {"vertices": n_vert, "vertices_per_sec": res["vertices_per_sec"],
                "searchlight_s": res["elapsed_s"], "cli_s": cli_s,
                "dataset_s": dataset_s, "mean_acc": means,
                "best_alpha_counts": {str(a): int(c) for a, c in
                                      zip(*np.unique(res["best_alpha"], return_counts=True))},
                "launches": launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES + EXTRA_PHASES} "
                         f"(default: {','.join(PHASES)})")
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

    results = {}
    for name in phases:
        t0 = time.time()
        out = {"build": phase_build, "kernel": phase_kernel, "gate": phase_gate,
               "cli": phase_cli, "profile": phase_profile}[name]()
        results[name] = out
        emit({"phase": name, "seconds": time.time() - t0, **out})

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    main_shape = results.get("kernel", {}).get("shapes", [{}])[0]
    emit({"kernels": [{
        "name": "chol_inv_panel",
        "route": "cuda",
        "source": "multimodal_decoding_tpu_torch/csrc/chol_inv_panel.cu",
        "replaces": "multimodal_decoding_tpu/ops/pallas_solvers.py:133",
        "shape": main_shape.get("shape"),
        "launches": results.get("cli", {}).get("launches"),
        "max_abs_err": main_shape.get("max_abs_err"),
        "max_rel_err": main_shape.get("max_rel_err"),
        "ms": main_shape.get("ms"),
        "kernel_ms": main_shape.get("ms"),  # the same time, under PERF.md's column name
        "plain_ms": main_shape.get("plain_ms"),
        "bound_ms": main_shape.get("bound_ms"),
        "bound_by": main_shape.get("bound_by"),
        "library_ms": main_shape.get("library_ms"),
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
