"""Rules the PyTorch port keeps:

- nothing in rsis_tpu_torch/, and none of chip_smoke.py, chip_bf16_gap.py
  and chip_k5_step.py, imports jax, flax or rsis_tpu: the port keeps its
  own copies of what it needs;
- an entry point asked for no device runs on CUDA, and raises where there
  is none, instead of running on the CPU (the trainer with each of its
  options, ``cli.verify_parity --device`` too);
- importing the kernel modules needs no nvcc and compiles nothing: kernels
  build on their first CUDA use;
- a kernel wrapper given a tensor that is neither on the CPU nor on a CUDA
  device raises instead of falling back to its plain version."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "rsis_tpu"}


def _port_files():
    files = sorted((ROOT / "rsis_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "chip_bf16_gap.py",
                    ROOT / "chip_k5_step.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 10
    bad = {str(p.relative_to(ROOT)): sorted(set(_imported_roots(p))
                                            & FORBIDDEN)
           for p in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_make_forward_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is usable")
    from rsis_tpu_torch import Config
    from rsis_tpu_torch.evals.forward import make_forward
    with pytest.raises(RuntimeError, match="CUDA"):
        make_forward(Config(base_model="tiny", hidden_size=16))


def test_make_train_step_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is usable")
    from rsis_tpu_torch import Config
    from rsis_tpu_torch.train.step import create_train_state, make_train_step
    cfg = Config(base_model="tiny", hidden_size=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(cfg)


def test_trainer_and_cli_train_without_device_need_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is usable")
    from rsis_tpu_torch import Config
    from rsis_tpu_torch.cli.train import main
    from rsis_tpu_torch.train.loop import Trainer
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(Config(base_model="tiny", hidden_size=16))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-dataset", "synthetic", "-base_model", "tiny",
              "-models_root", str(tmp_path)])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("change", [
    {"augment": True, "augment_on_device": False}, {"transfer": True},
    {"torch_encoder": "resnet101.pth"}, {"visdom": True}])
def test_trainer_options_without_device_need_cuda(change, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is usable")
    from rsis_tpu_torch import Config
    from rsis_tpu_torch.train.loop import Trainer
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(Config(base_model="tiny", hidden_size=16,
                       models_root=str(tmp_path), **change))
    assert not any(tmp_path.iterdir())


def test_verify_parity_on_the_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is usable")
    from rsis_tpu_torch.cli.verify_parity import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main([str(tmp_path / "encoder.pt"), str(tmp_path / "decoder.pt"),
              "--device"])


def test_import_needs_no_nvcc_and_builds_nothing(tmp_path):
    code = (
        "import subprocess\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a process was started at import')\n"
        "subprocess.Popen = refuse\n"
        "import rsis_tpu_torch.ops._build as b\n"
        "import rsis_tpu_torch.ops.fused_cell, rsis_tpu_torch.ops.mask_head\n"
        "import rsis_tpu_torch.models.rsis, rsis_tpu_torch.evals.forward\n"
        "import rsis_tpu_torch.ops.conv3x3, rsis_tpu_torch.ops.lap\n"
        "import rsis_tpu_torch.ops.fused_cell_vjp\n"
        "import rsis_tpu_torch.ops.matching\n"
        "import rsis_tpu_torch.train.step, rsis_tpu_torch.data.synthetic\n"
        "import rsis_tpu_torch.ops.warp, rsis_tpu_torch.data.device_aug\n"
        "import rsis_tpu_torch.train.loop, rsis_tpu_torch.cli.train\n"
        "import rsis_tpu_torch.ops.clstm_step, rsis_tpu_torch.cli.eval\n"
        "import rsis_tpu_torch.cli.eval_cityscapes\n"
        "import rsis_tpu_torch.cli.eval_leaves, rsis_tpu_torch.cli.predict\n"
        "import rsis_tpu_torch.evals.visualize\n"
        "import rsis_tpu_torch.data.tools.pascal_precompute\n"
        "import rsis_tpu_torch.cli.verify_parity\n"
        "import rsis_tpu_torch.models.torch_import\n"
        "import rsis_tpu_torch.utils.profiling\n"
        "import rsis_tpu_torch.utils.plot_curves\n"
        "import rsis_tpu_torch.kernels._binding as rle\n"
        "assert rle._lib is None\n"
        "assert b.load.cache_info().currsize == 0\n"
        "try:\n"
        "    b._nvcc()\n"
        "except RuntimeError:\n"
        "    print('no nvcc')\n")
    env = {"PATH": os.path.dirname(sys.executable),
           "CUDA_HOME": str(tmp_path / "no-cuda"),
           "PYTHONPATH": str(ROOT), "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "no nvcc" in out.stdout


@pytest.mark.parametrize("cli", ["eval", "eval_cityscapes", "eval_leaves",
                                 "predict"])
def test_eval_entry_points_without_device_need_cuda(cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is usable")
    import importlib
    main = importlib.import_module(f"rsis_tpu_torch.cli.{cli}").main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-models_root", str(tmp_path), "-predict_input",
              str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_wrappers_do_not_fall_back_off_the_cpu():
    from rsis_tpu_torch.ops.fused_cell import fused_cell_rowmajor
    from rsis_tpu_torch.ops.mask_head import mask_head_fused_kernel
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_cell_rowmajor(torch.empty(1, 2, 4, 3, **meta), None,
                            torch.empty(1, 2, 4, 3, **meta),
                            torch.empty(1, 2, 16, 3, **meta),
                            torch.empty(16, 36, **meta), cx=0, ch=4)
    with pytest.raises(ValueError, match="no kernel"):
        mask_head_fused_kernel(torch.empty(1, 2, 4, 3, **meta),
                               torch.empty(1, 4, 3, 3, **meta),
                               torch.empty(1, **meta))


def _meta_cell(ch=4, cx=0):
    """Forward operands and output cotangents of one cell on ``meta``."""
    m = dict(device="meta")
    return ([torch.empty(1, 2, ch, 3, **m), None,
             torch.empty(1, 2, ch, 3, **m), torch.empty(1, 2, 4 * ch, 3, **m),
             torch.empty(4 * ch, 9 * (cx + ch), **m)],
            [torch.empty(1, 2, ch, 3, **m), torch.empty(1, 2, ch, 3, **m)])


def test_training_wrappers_do_not_fall_back_off_the_cpu():
    from rsis_tpu_torch.ops.conv3x3 import conv3x3_rowmajor
    from rsis_tpu_torch.ops.fused_cell_vjp import (FusedCellFunction,
                                                   cell_backward_dgates,
                                                   weight_grad_rowmajor)
    from rsis_tpu_torch.ops.lap import solve_lap_batch
    from rsis_tpu_torch.ops.mask_head import MaskHeadFunction
    from rsis_tpu_torch.ops.warp import affine_warp
    meta = dict(device="meta")
    ops, (dh, dc) = _meta_cell()
    calls = [
        lambda: cell_backward_dgates(*ops, dh, dc, cx=0, ch=4),        # K4
        lambda: weight_grad_rowmajor(ops[0], None, ops[3], cx=0, ch=4),
        lambda: conv3x3_rowmajor(ops[3], torch.empty(4, 144, **meta),
                                 cin=16, cout=4),                      # K3
        lambda: solve_lap_batch(torch.empty(2, 3, 5, **meta)),         # K6
        lambda: affine_warp(torch.empty(1, 4, 6, 3, **meta),           # K7
                            torch.empty(1, 4, 6, dtype=torch.uint8, **meta),
                            torch.eye(3, **meta)[None]),
        lambda: FusedCellFunction.apply(*ops, 0, 4),
        lambda: MaskHeadFunction.apply(torch.empty(1, 2, 4, 3, **meta),
                                       torch.empty(1, 4, 3, 3, **meta),
                                       torch.empty(1, **meta)),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="no kernel"):
            call()
