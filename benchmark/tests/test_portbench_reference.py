"""The plain reference against the port's plain paths at a tiny
configuration on the CPU, and what the reference and the harness
import."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import loops, weights
from benchmark.reference import infer as ref_infer
from benchmark.reference import lap
from benchmark.reference import train as ref_train
from benchmark.reference.precision import Precision
from benchmark.tests import tiny

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "rsis_tpu"}


def _weights(cfg, seed=3):
    return weights.draw(cfg["base_model"], cfg["hidden_size"],
                        cfg["num_classes"], seed, "cpu")


def test_forward_matches_the_port():
    from rsis_tpu_torch.config import Config
    from rsis_tpu_torch.evals.forward import make_forward
    cell = tiny.cell(tiny.INFER_CELL, height=64, width=128, T=3)
    c = cell.config
    enc, dec, pool = loops.inputs(cell, 5, "cpu")
    port = make_forward(Config.from_dict(c), T=3, device="cpu")(
        (enc, dec), pool[0])
    ref = ref_infer.forward(enc, dec, pool[0], 3, c["hidden_size"],
                            Precision("fp32"), rows=1,
                            base_model=c["base_model"])
    for mine, theirs in zip(port, ref):
        assert mine.shape == theirs.shape
        assert float((mine.float() - theirs).abs().max()) < 1e-4


@pytest.mark.parametrize("name", [tiny.TRAIN_CELL, tiny.AUG_CELL])
def test_train_steps_match_the_port(name):
    """Three steps from the same weights, batches and generator seed:
    the losses, the first gradient as Adam takes it and the change."""
    from rsis_tpu_torch.config import Config
    from rsis_tpu_torch.train.step import create_train_state, make_train_step
    cell = tiny.cell(name)
    c, mix = cell.config, cell.mix
    cfg = Config.from_dict(c)
    enc, dec, pool = loops.inputs(cell, 7, "cpu")
    state = create_train_state(cfg, weights=(enc, dec), device="cpu")
    step, _ = make_train_step(cfg, T=mix["T"], device="cpu")
    rng = torch.Generator().manual_seed(99)
    losses = []
    for k in range(3):
        state, m = step(state, pool[k], loops.train_flags(mix), rng)
        losses.append(m.tolist())
        if k == 0:
            grad1 = loops.first_gradient_norms(state)
    change = loops.change_norms(state.params(), enc, dec)
    ref = ref_train.train_steps(c, enc, dec, pool[:3], mix["flags"],
                                mix["T"], 99, Precision("fp32"))
    numbers, _ = loops.compare_train(losses, grad1, change, ref, enc, dec)
    assert numbers["loss_gap"] < 1e-4
    assert numbers["grad_gap"] < 2e-2
    assert numbers["change_gap"] < 2e-2
    for mine, theirs in zip(losses, ref["losses"]):
        assert mine == pytest.approx(theirs, rel=1e-3, abs=1e-6)


def test_augmentation_draw_matches_the_port():
    from rsis_tpu_torch.data.device_aug import augment_wire_batch
    cell = tiny.cell(tiny.AUG_CELL)
    c = cell.config
    _, _, pool = loops.inputs(cell, 8, "cpu")
    img, tgt = pool[0]
    x, y = ref_train.unpack(img, tgt)[:2]
    mine = ref_train.augment(torch.Generator().manual_seed(4), x, y, c)
    port = augment_wire_batch(torch.Generator().manual_seed(4), x, y,
                              c["rotation"], c["translation"], c["shear"],
                              ref_train.zoom_range(c))
    assert torch.equal(mine[0], port[0]) and torch.equal(mine[1], port[1])


def test_assignment_is_optimal():
    scipy = pytest.importorskip("scipy.optimize")
    gen = torch.Generator().manual_seed(0)
    costs = torch.rand((6, 7, 4), generator=gen).numpy()
    costs[:, 5:, :] = 10.0
    for b, match in enumerate(lap.match(costs)):
        rows, cols = scipy.linear_sum_assignment(costs[b])
        assert len(set(match)) == 4
        assert costs[b][match, range(4)].sum() == pytest.approx(
            costs[b][rows, cols].sum(), rel=1e-6)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_side():
    """Whole top-level names: ``rsis_tpu_torch`` is not ``rsis_tpu``."""
    for path in BENCH.rglob("*.py"):
        found = set(_imports(path)) & JAX_SIDE
        assert not found, (path, found)
    for path in (BENCH / "reference").glob("*.py"):
        assert "rsis_tpu_torch" not in set(_imports(path)), path


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_reference_loads_no_program():
    loaded = _loaded_after(
        "import benchmark.reference.model, benchmark.reference.infer, "
        "benchmark.reference.train, benchmark.reference.lap")
    assert not loaded & (JAX_SIDE | {"rsis_tpu_torch"})


def test_a_run_loads_no_jax_side():
    loaded = _loaded_after(
        "import torch\ntorch.set_num_threads(2)\n"
        "from benchmark.tests import tiny\n"
        "rc, line, _ = tiny.run_tiny(tiny.cell(tiny.INFER_CELL, limits={}))\n"
        "assert rc == 0, rc")
    assert "rsis_tpu_torch" in loaded
    assert not loaded & JAX_SIDE


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch):
    cell = tiny.cell(tiny.INFER_CELL, limits={})
    monkeypatch.setitem(sys.modules, "rsis_tpu", object())
    rc, line, _ = tiny.run_tiny(cell)
    assert rc == 3 and line is None


def test_a_bare_benchmark_directory_prints_no_result(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: the port is not
    there, so a run fails without a result line."""
    import shutil
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import argparse, sys\n"
            "from benchmark import run\n"
            "from benchmark.tests import tiny\n"
            "cell = tiny.cell(tiny.INFER_CELL)\n"
            "args = argparse.Namespace(workload=cell.name, seed=1, "
            "seconds=0.1, trace=0)\n"
            "sys.exit(run.run_cell(tiny.MANIFEST, args, 'cpu', 0.0, "
            "cell=cell))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert "rsis_tpu_torch" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
