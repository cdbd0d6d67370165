"""The port's inference forward (``evals/forward.make_forward``, the path
the CVPPP leaf recipe's benchmark cell runs) against the benchmark's
plain fp32 reference (``benchmark/reference/infer.forward``) where the
decode pyramid's widths are odd, as they are at the recipe's 400x400
(13, 25, 50, 100, 200).

At 80x80 the encoder's five scales are 3, 5, 10, 20 and 40 wide: each
cell's input is the coarser state upsampled to the skip's own size (3 to
5, not to 6), in the port as in the reference. The CVPPP configuration
of the benchmark (``benchmark/configs/rsis-leaves-bf16.json``) runs here
in fp32 with hidden 16 and resnet50, weights drawn from a seed as the
benchmark draws them. On the CPU the port's kernels take their plain
versions, so this holds the port's model code (hoisted skip terms, the
row-major decode, the upsample's taps, the heads) to the reference's.
"""

import sys
from pathlib import Path

import torch

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from benchmark import loops, run  # noqa: E402
from benchmark.reference import infer as ref_infer  # noqa: E402
from benchmark.reference import model as ref_model  # noqa: E402
from benchmark.reference.precision import Precision  # noqa: E402

# Both sides compute in fp32 and sum in other orders (the port hoists the
# skip part of each gate convolution out of the step and upsamples by
# two-tap tables; the reference convolves the concatenation and calls
# F.interpolate): the outputs, sigmoids and softmax probabilities in
# [0, 1], differ by a few fp32 ulps, 3.0e-7 to 3.6e-7 at most over three
# seeds at this size; 1e-5 leaves thirty times that for other seeds and
# the T steps' recurrence.
TOL = 1e-5


def _cell():
    c = run.load_cell(run.load_json(run.MANIFEST), "leaves-infer-400x400-b256")
    c.config = dict(c.config, hidden_size=16, base_model="resnet50",
                    compute_dtype="float32", tf32=False)
    c.mix = dict(c.mix, batch=2, height=80, width=80, T=3, pool_batches=1)
    return c


def test_leaves_forward_matches_the_reference_at_odd_widths():
    from rsis_tpu_torch.config import Config
    from rsis_tpu_torch.evals.forward import make_forward
    cell = _cell()
    c, mix = cell.config, cell.mix
    enc, dec, pool = loops.inputs(cell, 2**31 + 21, "cpu")
    x = pool[0]
    with torch.no_grad():
        skips = ref_model.encoder(enc, x.permute(0, 3, 1, 2).contiguous(),
                                  Precision("fp32"), False, c["base_model"])
    assert [s.shape[-1] for s in skips] == [3, 5, 10, 20, 40]
    port = make_forward(Config.from_dict(c), T=mix["T"], device="cpu")(
        (enc, dec), x)
    ref = ref_infer.forward(enc, dec, x, mix["T"], c["hidden_size"],
                            Precision("fp32"), rows=2,
                            base_model=c["base_model"])
    for name, mine, theirs in zip(("masks", "classes", "stops"), port, ref):
        assert mine.shape == theirs.shape, name
        gap = float((mine.float() - theirs).abs().max())
        assert gap < TOL, (name, gap)
