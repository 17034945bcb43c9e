"""The port's examples against the JAX package's, on the same synthetic data.

Each JAX example is loaded by path (``examples/`` is not a package) and its
``main`` run with its own arguments; the port's counterpart in
``multimodal_decoding_tpu_torch/examples/`` runs with the same arguments and
``--device cpu``.  Their printed lines must be equal once the temporary
paths, the device and the timings the library prints are spelled alike, and
they must write the same artifacts.

The searchlight examples run on a regular icosphere, whose exact distance
ties the two packages' exact kNN break differently (ROADMAP C4: sklearn's
KD-tree there, scipy's here; 16 of full_pipeline's 41 neighbourhoods
differ).  So there the port's searchlight is handed the JAX package's kNN,
as the shared adjacency cache would hand it over.
"""

import importlib.util
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from multimodal_decoding_tpu import config as jax_config
from multimodal_decoding_tpu_torch import config as torch_config
from multimodal_decoding_tpu_torch.examples import (  # noqa: F401 (looked up by name)
    full_pipeline,
    imagery_and_cross_modal,
    intersession_alignment_qc,
    model_comparison,
    nearest_neighbor_ranking,
    roi_decoding,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_PATHS = ("FMRI_STIM_INFO_DIR", "LATENT_FEATURES_DIR", "BETAS_CACHE_DIR")


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def isolated(tmp_path, monkeypatch):
    """The examples set the config paths and make temporary directories:
    both are put back after the test, and mkdtemp lands under tmp_path."""
    for cfg in (jax_config, torch_config):
        for name in CONFIG_PATHS:
            monkeypatch.setattr(cfg, name, getattr(cfg, name))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def _spelled_alike(out: str, paths: dict) -> list:
    """``out``'s lines with ``paths`` ({path: placeholder}) replaced and the
    device and timings the library prints dropped."""
    for path, placeholder in paths.items():
        out = out.replace(path, placeholder)
    out = re.sub(r" \| DEVICE: \S+", "", out)
    out = re.sub(r"Searchlight time: \d+s \(\d+ vertices/s\)", "Searchlight time: <t>", out)
    out = re.sub(r"Elapsed time: \d+s", "Elapsed time: <t>", out)
    return out.splitlines()


def _outputs(name, argv, monkeypatch, capsys, jax_argv=None):
    """(JAX example's stdout, port example's stdout) for the same arguments."""
    jax_mod = _jax_example(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *(argv if jax_argv is None else jax_argv)])
    capsys.readouterr()
    jax_mod.main()
    jax_out = capsys.readouterr().out
    port = sys.modules[f"multimodal_decoding_tpu_torch.examples.{name}"]
    port.main([*argv, "--device", "cpu"])
    return jax_out, capsys.readouterr().out


def _files(root):
    return sorted(os.path.relpath(os.path.join(base, f), root)
                  for base, _, fs in os.walk(root) for f in fs)


def _artifacts(root):
    """The files under ``root``, run logs aside; a betas cache's name ends in
    a hash of its source path, which differs between two work directories."""
    return sorted(re.sub(r"_[0-9a-f]{16}\.npz$", "_<hash>.npz", f) for f in _files(root)
                  if "runlog" not in f)


def test_full_pipeline_matches_jax(isolated, monkeypatch, capsys):
    from multimodal_decoding_tpu.io.surface import knn_adjacency as jax_knn
    from multimodal_decoding_tpu_torch.decoding import searchlight as TS

    monkeypatch.setattr(TS, "knn_adjacency", lambda coords, k: jax_knn(coords, k))
    jax_wd, torch_wd = str(isolated / "jax"), str(isolated / "torch")
    jax_out, torch_out = _outputs("full_pipeline", ["--workdir", torch_wd], monkeypatch,
                                  capsys, jax_argv=["--workdir", jax_wd])
    jax_lines = _spelled_alike(jax_out, {jax_wd: "<workdir>"})
    torch_lines = _spelled_alike(torch_out, {torch_wd: "<workdir>"})
    steps = [line for line in torch_lines if line.startswith("[")]
    assert [line[:5] for line in steps] == ["[1/4]", "[2/4]", "[3/4]", "[4/4]"]
    assert torch_lines == jax_lines
    # the same artifacts under each work directory
    assert _artifacts(torch_wd) == _artifacts(jax_wd)


@pytest.mark.parametrize("name,prefix", [("model_comparison", "mmd_demo_"),
                                         ("roi_decoding", "mmd_roi_")])
def test_whole_brain_examples_match_jax(isolated, monkeypatch, capsys, name, prefix):
    jax_out, torch_out = _outputs(name, [], monkeypatch, capsys)

    def spelled_alike(out):
        return _spelled_alike(re.sub(re.escape(prefix) + r"\w+", prefix + "<tmp>", out), {})

    assert spelled_alike(torch_out) == spelled_alike(jax_out)
    assert re.search(r"\d\.\d{3}", torch_out)
    # each run made one temporary dataset, the same files in both
    runs = sorted(d for d in os.listdir(isolated) if d.startswith(prefix))
    assert len(runs) == 2
    assert _artifacts(isolated / runs[0]) == _artifacts(isolated / runs[1])


@pytest.fixture(scope="module")
def results_dir(tmp_path_factory):
    """A whole-brain results tree of the port (CPU), on a synthetic subject."""
    from multimodal_decoding_tpu_torch.data.features import _load_feature_pickle
    from multimodal_decoding_tpu_torch.data.synthetic import make_synthetic_dataset
    from multimodal_decoding_tpu_torch.decoding.whole_brain import WholeBrainConfig, run

    root = tmp_path_factory.mktemp("wb")
    info = make_synthetic_dataset(str(root), n_train=60, n_vertices=50, latent_dim=10)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_config, "FMRI_STIM_INFO_DIR", info["stim_info_dir"])
        mp.setattr(torch_config, "LATENT_FEATURES_DIR", info["features_dir"])
        mp.setattr(torch_config, "BETAS_CACHE_DIR", str(root / "cache"))
        _load_feature_pickle.cache_clear()
        run(WholeBrainConfig(betas_dir=info["betas_dir"], subjects=["sub-01"],
                             models=[info["model"]], alphas=(1e0, 1e2), surface=True,
                             out_dir=str(root / "out"), device="cpu"))
    return str(root / "out")


@pytest.mark.parametrize("top_k", [None, "3"])
def test_nearest_neighbor_ranking_matches_jax(results_dir, monkeypatch, capsys, top_k):
    (path,) = [os.path.join(results_dir, f) for f in _files(results_dir)
               if f.endswith("results.p")]
    argv = [path] + (["--top-k", top_k] if top_k else [])
    jax_out, torch_out = _outputs("nearest_neighbor_ranking", argv, monkeypatch, capsys)
    assert torch_out == jax_out
    assert "median identification rank" in torch_out and len(torch_out.splitlines()) == 11


@pytest.mark.parametrize("recompute", [False, True])
def test_imagery_and_cross_modal_matches_jax(results_dir, monkeypatch, capsys, recompute):
    argv = ["--results-dir", results_dir] + (["--recompute"] if recompute else [])
    jax_out, torch_out = _outputs("imagery_and_cross_modal", argv, monkeypatch, capsys)
    assert torch_out == jax_out
    assert "== mental imagery ==" in torch_out and "== zero-shot cross-modal ==" in torch_out


def test_intersession_alignment_qc_matches_jax(tmp_path, monkeypatch, capsys):
    jax_dir, torch_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_mod = _jax_example("intersession_alignment_qc")
    monkeypatch.setattr(sys, "argv", ["qc.py", "--out-dir", jax_dir, "--bins", "32"])
    capsys.readouterr()
    jax_mod.main()
    jax_out = capsys.readouterr().out
    intersession_alignment_qc.main(["--out-dir", torch_dir, "--bins", "32"])
    torch_out = capsys.readouterr().out
    assert torch_out.replace(torch_dir, "<out>") == jax_out.replace(jax_dir, "<out>")
    for d in (jax_dir, torch_dir):
        assert os.path.getsize(os.path.join(d, "mi_t1_t1.png")) > 1000
    rows = intersession_alignment_qc.qc_table(
        intersession_alignment_qc.synthetic_sessions(n_subjects=1, n_sessions=2,
                                                     shape=(8, 9, 7)), bins=16)
    ref = jax_mod.qc_table(jax_mod.synthetic_sessions(n_subjects=1, n_sessions=2,
                                                      shape=(8, 9, 7)), bins=16)
    assert rows == ref


@pytest.mark.parametrize("name,argv", [
    ("full_pipeline", ["--workdir", "wd"]), ("model_comparison", []), ("roi_decoding", []),
    ("nearest_neighbor_ranking", ["results.p"]),
    ("imagery_and_cross_modal", ["--results-dir", "results"]),
])
def test_examples_refuse_to_fall_back_to_cpu(isolated, monkeypatch, name, argv):
    """Without a GPU and without --device cpu, an example raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(isolated)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sys.modules[f"multimodal_decoding_tpu_torch.examples.{name}"].main(argv)
    assert os.listdir(isolated) == []


def test_examples_run_as_modules(tmp_path):
    """``python -m multimodal_decoding_tpu_torch.examples.<name>`` runs, with no
    JAX importable."""
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.modules['multimodal_decoding_tpu'] = None; "
            "sys.argv = ['qc', '--out-dir', sys.argv[1], '--bins', '16']; "
            "runpy.run_module('multimodal_decoding_tpu_torch.examples.intersession_alignment_qc',"
            " run_name='__main__')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == f"wrote {tmp_path / 'mi_t1_t1.png'}"
    assert np.isfinite(float(out.stdout.splitlines()[1].split()[-1]))
