"""The port stands alone: no JAX, no JAX package, no silent CPU fallback."""

import ast
import importlib.util
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import multimodal_decoding_tpu_torch as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_decoding_tpu")


def _port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, prefix=port.__name__ + "."):
        names.append(info.name)
    return sorted(names)


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, dirs, fs in os.walk(os.path.dirname(port.__file__)):
        dirs[:] = [d for d in dirs if d != "_build"]  # build output, not source
        files += [os.path.join(base, f) for f in fs if f.endswith(".py")]
    return sorted(files)


def test_every_port_module_is_found():
    mods = _port_modules()
    for expected in ("device", "interop", "config", "ops._cuda_build", "ops.hopper_solvers",
                     "ops.hopper_metrics", "ops.solvers", "ops.ridge", "ops.metrics",
                     "decoding.searchlight_engine", "parallel.searchlight_runner",
                     "cli.run_searchlight", "io.surface", "data.synthetic",
                     "decoding.whole_brain", "cli.decode_whole_brain", "utils.threefry",
                     "ops._host_build", "ops.tfce", "ops.stats", "decoding.permutation",
                     "cli.permutation_testing", "decoding.study", "cli.run_study",
                     "parallel.ingest", "parallel.mesh", "parallel.multihost",
                     "parallel.distributed", "entry", "analysis.calibration",
                     "analysis.simulation", "analysis.noise_ceilings", "io.annot", "io.atlas",
                     "decoding.cluster_postproc", "viz.maps", "viz.reporting", "viz.freeview",
                     "cli.export_results_maps", "cli.make_roi_mask", "preprocessing.events",
                     "preprocessing.spm_design", "preprocessing.masks",
                     "preprocessing.beta_symlinks", "preprocessing.surface_transform",
                     "extraction.imagebind", "extraction.gabor", "extraction.motion_energy",
                     "extraction.harness", "extraction.extractors", "extraction.visualbert",
                     "cli.extract_features", "utils.profiling", "viz.plotting", "viz.roi",
                     "viz.figures", "viz.comparison_plots", "cli.plot_results"):
        assert f"{port.__name__}.{expected}" in mods


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_of_jax_or_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            tops = [(node.module or "").split(".")[0]] if node.level == 0 else []
        else:
            continue
        for top in tops:
            assert top not in FORBIDDEN, f"{path}:{node.lineno} imports {top}"


def _imported_names(path, package):
    """Every module (or module.name) that ``path``, a file of the package
    ``package``, imports, relative imports resolved."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package.split(".")[:len(package.split(".")) + 1 - node.level]
            module = ".".join(base + [node.module] if node.level else [node.module])
            yield from (f"{module}.{a.name}" for a in node.names)


def test_ops_and_parallel_import_nothing_of_the_decoding_layer_above_them():
    """The selection settings a device ships with live in ``ops/precision``:
    nothing under ``ops/`` imports ``decoding.*``, and ``parallel/`` imports
    only ``decoding.searchlight_engine``, the block steps it drives."""
    decoding = f"{port.__name__}.decoding"
    engine = f"{decoding}.searchlight_engine"
    pkg = os.path.dirname(port.__file__)
    upward, engine_users = [], set()
    for layer in ("ops", "parallel"):
        for base, _, files in os.walk(os.path.join(pkg, layer)):
            rel = os.path.relpath(base, os.path.dirname(pkg)).replace(os.sep, ".")
            for f in (f for f in files if f.endswith(".py")):
                for name in _imported_names(os.path.join(base, f), rel):
                    if not (name == decoding or name.startswith(decoding + ".")):
                        continue
                    if layer == "parallel" and name.startswith(engine + "."):
                        engine_users.add(f)
                    else:
                        upward.append(f"{layer}/{f} imports {name}")
    assert upward == []
    assert engine_users == {"searchlight_runner.py", "distributed.py"}


def test_port_and_chip_smoke_import_with_jax_blocked():
    """Import everything with ``jax`` and the JAX package made unimportable."""
    code = "\n".join([
        "import importlib, importlib.util, sys",
        *[f"sys.modules[{name!r}] = None" for name in FORBIDDEN],
        f"sys.path.insert(0, {ROOT!r})",
        f"for name in {_port_modules()!r}:",
        "    importlib.import_module(name)",
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {os.path.join(ROOT, 'chip_smoke.py')!r})",
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))",
        "assert not any(m == 'jax' or m.startswith('jax.') for m, v in sys.modules.items() if v is not None)",
        "print('isolated ok')",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout


def test_port_imports_without_the_figure_stack():
    """The card machine has no transformers, matplotlib, pandas, seaborn or
    PIL: the package and chip_smoke.py import with them made unimportable."""
    blocked = ("transformers", "matplotlib", "pandas", "seaborn", "PIL")
    code = "\n".join([
        "import importlib, importlib.util, sys",
        *[f"sys.modules[{name!r}] = None" for name in blocked + FORBIDDEN],
        f"sys.path.insert(0, {ROOT!r})",
        f"for name in {_port_modules()!r}:",
        "    importlib.import_module(name)",
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {os.path.join(ROOT, 'chip_smoke.py')!r})",
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))",
        f"assert not any(m.split('.')[0] in {blocked!r} for m, v in sys.modules.items() if v is not None)",
        "print('figure-free ok')",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert "figure-free ok" in out.stdout


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, tmp_path):
    """Without a GPU and without an explicit device="cpu", every entry point raises."""
    import numpy as np

    from multimodal_decoding_tpu_torch.cli import decode_whole_brain as wb_cli
    from multimodal_decoding_tpu_torch.cli import run_searchlight as cli
    from multimodal_decoding_tpu_torch.decoding import searchlight as S
    from multimodal_decoding_tpu_torch.decoding import whole_brain as W
    from multimodal_decoding_tpu_torch.device import resolve_device
    from multimodal_decoding_tpu_torch.interop import (
        block_inputs_from_numpy,
        gram_cache_from_numpy,
    )
    from multimodal_decoding_tpu_torch.ops import metrics as M
    from multimodal_decoding_tpu_torch.ops import ridge as R
    from multimodal_decoding_tpu_torch.parallel.searchlight_runner import run_searchlight

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(10, 8).astype(np.float32)
    y = rng.randn(10, 3).astype(np.float32)
    adj = np.stack([np.arange(3) + i for i in range(4)]).astype(np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_searchlight(x, x[:4], x[:3], y, y[:4], y[:3], adj,
                        np.array(["caption", "caption", "image", "image"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        block_inputs_from_numpy(X_all=x, idx=adj)
    assert block_inputs_from_numpy(device="cpu", X_all=x)["X_all"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.run(S.SearchlightConfig(betas_dir=str(tmp_path), mesh_coords={}, n_neighbors=3))
    assert cli.get_args([]).device == "cuda"
    assert S.default_cv_solver() == "schur-cb"

    # the whole-brain decoder: its CLI, run, the gram, the CV and the scores
    wb_argv = ["--betas-dir", str(tmp_path), "--subjects", "sub-01", "--out-dir",
               str(tmp_path / "wb")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wb_cli.main(wb_argv)
    assert wb_cli.get_args(wb_argv).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        W.run(W.WholeBrainConfig(betas_dir=str(tmp_path), out_dir=str(tmp_path / "wb")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        W.GramCache(x, x[:4], x[:3])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        W.default_wb_cv_solver()
    assert W.default_wb_cv_solver("cpu") is None
    K = x @ x.T
    for call in (lambda: R.gram_matrix(x), lambda: R.cross_matrix(x[:4], x),
                 lambda: R.ridge_cv_dual(K, y, [1.0, 10.0], n_splits=2),
                 lambda: R.dual_ridge_fit(K, y, 1.0), lambda: R.dual_ridge_predict(K, y),
                 lambda: gram_cache_from_numpy(K, K[:4], K[:3]),
                 lambda: M.pairwise_accuracy(y, y)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

    # the analyses: calibration, the simulation's classifier, CSLS, rescoring
    from multimodal_decoding_tpu_torch.analysis import calibration as AC
    from multimodal_decoding_tpu_torch.analysis import simulation as AS
    from multimodal_decoding_tpu_torch.viz import reporting as VR

    labels = np.arange(10) % 2
    for call in (lambda: AC.t_threshold_monte_carlo(n_perms=4, n_latents=4, dim=8),
                 lambda: AS.ridge_classifier_fit_predict(x, labels, [x], 1.0, 2),
                 lambda: AS.train_and_eval("just_noise", n_seeds=1, n_classes=2,
                                           n_train_per_class=2, n_test_per_class=2,
                                           n_voxels=4),
                 lambda: M.get_distance_matrix_csls(y, y, knn=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    import pickle

    res = dict(model="clip", predictions=y[:4], latents=y[:4], pairwise_acc_images=0.5,
               stimulus_types=np.array(["caption", "caption", "image", "image"]))
    os.makedirs(tmp_path / "res")
    with open(tmp_path / "res" / "results.p", "wb") as f:
        pickle.dump(res, f)
    if importlib.util.find_spec("pandas") is not None:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            VR.load_results_frame(str(tmp_path / "res"), recompute_metrics=True)
    assert R.ridge_cv_dual(K, y, [1.0, 10.0], n_splits=2, device="cpu")[2].device.type == "cpu"

    # group statistics and the study: their configs, runs, CLIs and the t-maps
    from multimodal_decoding_tpu_torch.cli import permutation_testing as perm_cli
    from multimodal_decoding_tpu_torch.cli import run_study as study_cli
    from multimodal_decoding_tpu_torch.decoding import permutation as P
    from multimodal_decoding_tpu_torch.decoding import study as ST
    from multimodal_decoding_tpu_torch.ops import stats as T

    assert P.PermutationConfig().device is None and ST.StudyConfig("", {}).device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.run(P.PermutationConfig(out_dir=str(tmp_path / "perm")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ST.run_study(ST.StudyConfig(betas_dir=str(tmp_path), meshes={}))
    with pytest.raises(RuntimeError, match="no CUDA device"):  # fast math as well
        ST.run_study(ST.StudyConfig(betas_dir=str(tmp_path), meshes={}, fast_math=True))
    perm_argv = ["--n-neighbors", "3", "--mesh-dir", str(tmp_path / "no_meshes")]
    study_argv = ["--betas-dir", str(tmp_path), "--mesh-dir", str(tmp_path / "no_meshes")]
    for module, argv in ((perm_cli, perm_argv), (study_cli, study_argv)):
        assert module.get_args(argv).device == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main(argv)
    for call in (lambda: T.t_map(x, 0.5), lambda: T.null_t_maps(x[None], [[0]], 0.5),
                 lambda: T.composite_t_maps({m: x[0] for m in T.T_VAL_METRICS}),
                 lambda: P.calc_t_values({}, [], [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")

    # the multi-GPU slice: meshes, the entry and the dry run
    from multimodal_decoding_tpu_torch import entry as E
    from multimodal_decoding_tpu_torch.parallel import mesh as PM

    for call in (PM.vertex_mesh, PM.feature_mesh, PM.init_world, E.entry,
                 lambda: E.dryrun_multichip(1),
                 lambda: W.run(W.WholeBrainConfig(betas_dir=str(tmp_path), mesh="auto",
                                                  out_dir=str(tmp_path / "wb")))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
