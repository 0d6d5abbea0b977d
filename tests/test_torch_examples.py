"""The port's three examples (``examples/torch_*.py``) on the CPU with
small arguments, each printing its report, and the jax-free import check
of the dry-run's modules and the examples in a fresh interpreter."""

import importlib.util
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_example_reports_recall_and_footprint(capsys):
    recall = _example("torch_quickstart").main(
        ["--device", "cpu", "--n", "2000", "--queries", "16"])
    out = capsys.readouterr().out
    assert "recall@10" in out and "at SIFT1B scale" in out
    assert 0.0 < recall <= 1.0


def test_rag_serve_example_retrieves_for_every_request(capsys):
    toks, retrieved = _example("torch_rag_serve").main(
        ["--device", "cpu", "--requests", "2", "--prompt-len", "8",
         "--gen", "3"])
    out = capsys.readouterr().out
    assert toks.shape == (2, 3) and "neighbors/request" in out
    assert (retrieved >= 0).any(axis=1).all()


def test_train_lm_example_trains_and_checkpoints(capsys, tmp_path):
    losses = _example("torch_train_lm").main(
        ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
         "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert len(losses) == 2 and all(map(lambda v: v == v, losses))
    assert "loss" in out and "->" in out


def test_dryrun_modules_and_examples_import_no_jax():
    """A fresh interpreter that imports the dry-run's modules, the kernels'
    cost and the examples leaves ``jax`` out of ``sys.modules``."""
    code = (
        "import sys, importlib.util\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.op_stats, "
        "repro_torch.launch.roofline, repro_torch.launch.shapes, "
        "repro_torch.kernels.cost\n"
        "for n in ('torch_quickstart', 'torch_rag_serve', "
        "'torch_train_lm'):\n"
        "    s = importlib.util.spec_from_file_location(n, "
        f"'{ROOT / 'examples'}/' + n + '.py')\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(m == 'repro' or m.startswith('repro.') "
        "for m in sys.modules), 'repro imported'\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
