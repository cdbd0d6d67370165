"""The port's monitoring tools against the JAX package's:

- the dashboard (``utils/dashboard.py``) serves the monitor's metrics and
  snapshots on an ephemeral loopback port (``tests/test_dashboard.py``'s
  case);
- ``plot_curves.parse_train_log`` equals JAX's on a port trainer's
  ``train.log`` and on a handwritten log, and ``plot_curves`` writes its
  figure;
- ``profiling.self_times`` / ``op_table`` equal JAX's on the event lists
  of ``tests/test_profiling.py`` (by thread lane and over all threads),
  the default lane keeps the device kernels (category ``kernel``), and a
  ``torch.profiler`` trace on the CPU round-trips through
  ``load_trace_events`` and ``print_op_table``; ``step_timer`` appends;
- ``Monitor.snapshot``: the grid's size from the mask shape and T, the
  titles' class names drawn, and ``None`` with snapshots off."""

import gzip
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from rsis_tpu.utils.plot_curves import parse_train_log as jax_parse_train_log
from rsis_tpu.utils import profiling as jax_prof
from rsis_tpu_torch.config import Config
from rsis_tpu_torch.utils import monitor as mon
from rsis_tpu_torch.utils import plot_curves, profiling
from rsis_tpu_torch.utils.dashboard import Dashboard
from torch_threads import one_torch_thread  # noqa: F401


def test_dashboard_serves_metrics_and_snapshots(tmp_path):
    d = str(tmp_path)
    m = mon.Monitor(d, enable_snapshots=True)
    m.log("train", 0, 0, 1.5, 0.9, 0.3, 0.2)
    m.log("val", 0, 0, 1.2, 0.8, 0.25, 0.15)
    m.snapshot(0, np.random.rand(2, 8, 8), np.random.rand(2, 8, 8))
    m.close()

    dash = Dashboard(d, port=0).start()  # ephemeral port
    base = f"http://localhost:{dash.port}"
    try:
        page = urllib.request.urlopen(base + "/").read().decode()
        assert "rsis-tpu live training" in page
        recs = json.loads(urllib.request.urlopen(base + "/metrics").read())
        assert len(recs) == 2 and recs[0]["split"] == "train"
        assert recs[1]["total"] == 1.2
        snaps = json.loads(
            urllib.request.urlopen(base + "/snapshots").read())
        assert snaps == ["masks_epoch0000.png"]
        img = urllib.request.urlopen(base + f"/snap/{snaps[0]}").read()
        assert img[:8] == b"\x89PNG\r\n\x1a\n"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/nope")
        assert e.value.code == 404
    finally:
        dash.stop()


HANDWRITTEN = """{'seed': 1}
Epoch 0
iter 0:\ttotal:0.9000\tclass:1.1000\tiou:0.9000\tstop:0.4000\ttime:0.1
Epoch 0:\ttotal:0.9000\tclass:1.1000\tiou:0.9000\tstop:0.4000\t(train)
Epoch 0:\ttotal:0.8500\tclass:1.0500\tiou:0.8500\tstop:0.3900\t(val)
Saving checkpoint.
Epoch 1:\ttotal:8.1e-01\tclass:1.0\tiou:0.81\tstop:0.38\t(train)
Epoch 1:\ttotal:0.8000\tclass:1.0000\tiou:0.8000\tstop:0.3800\t(test)
Epoch 1:\ttotal:0.7900\tclass:0.9900\tiou:0.7900\tstop:0.3700\t(val)
"""


def _curves(c):
    return {split: dict(m) for split, m in c.items()}


def test_parse_train_log_equals_jax(tmp_path):
    from rsis_tpu_torch.train.loop import Trainer
    hand = tmp_path / "hand.log"
    hand.write_text(HANDWRITTEN)
    got = _curves(plot_curves.parse_train_log(str(hand)))
    assert got == _curves(jax_parse_train_log(str(hand)))
    assert got["train"]["total"] == [0.9, 0.81]
    assert got["val"]["stop"] == [0.39, 0.37]

    cfg = Config(dataset="synthetic", base_model="tiny", hidden_size=16,
                 num_classes=3, imsize=32, maxseqlen=2, gt_maxseqlen=3,
                 batch_size=4, max_epoch=2, print_every=1, num_workers=1,
                 synthetic_length=4, models_root=str(tmp_path),
                 model_name="m")
    Trainer(cfg, device="cpu").run()
    log = str(tmp_path / "m" / "train.log")
    got = _curves(plot_curves.parse_train_log(log))
    assert got == _curves(jax_parse_train_log(log))
    assert all(len(got[s][k]) == 2 for s in ("train", "val")
               for k in ("total", "class", "iou", "stop"))
    out = plot_curves.plot_curves("m", models_root=str(tmp_path))
    with open(out, "rb") as fp:
        assert fp.read(8) == b"\x89PNG\r\n\x1a\n"


def _evt(name, ts, dur, pid=1, tid=7, **kw):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, **kw}


LANE_META = {"ph": "M", "name": "thread_name", "pid": 1, "tid": 3,
             "args": {"name": "XLA Ops"}}
EVENT_LISTS = {
    "flat": [_evt("a", 0, 10), _evt("b", 20, 5), _evt("a", 30, 10)],
    "nested": [_evt("fusion", 0, 100), _evt("conv", 10, 30),
               _evt("conv", 50, 30)],
    "three_deep": [_evt("outer", 0, 100), _evt("mid", 10, 50),
                   _evt("inner", 20, 10)],
    "threads": [_evt("a", 0, 100, tid=1), _evt("b", 10, 50, tid=2)],
    "lane": [LANE_META, _evt("keep", 0, 10, tid=3),
             _evt("drop", 0, 10, tid=4)],
    "lane_no_meta": [_evt("keep", 0, 10, tid=3), _evt("drop", 0, 10, tid=4)],
    "back_to_back": [_evt("p", 0, 20), _evt("c1", 0, 10),
                     _evt("c2", 10, 10)],
    "grouping": [_evt("fusion.1", 0, 3000), _evt("fusion.2", 4000, 1000),
                 _evt("conv", 6000, 2000)],
}


@pytest.mark.parametrize("events", list(EVENT_LISTS))
@pytest.mark.parametrize("lane", [None, "XLA Ops"])
def test_self_times_and_op_table_equal_jax(events, lane):
    evs = EVENT_LISTS[events]
    assert profiling.self_times(evs, lane=lane) == \
        jax_prof.self_times(evs, lane=lane)
    group = (lambda n: n.split(".")[0])
    for kw in ({}, {"top": 2, "group": group}):
        assert profiling.op_table(evs, lane=lane, **kw) == \
            jax_prof.op_table(evs, lane=lane, **kw)


def test_default_lane_is_the_device_kernels(tmp_path):
    evs = [_evt("aten::conv2d", 0, 100, tid=9, cat="cpu_op"),
           _evt("void cell_staged_kernel<LstmForward>", 10, 40, pid=0,
                tid=7, cat="kernel"),
           _evt("Memcpy HtoD", 60, 5, pid=0, tid=7, cat="gpu_memcpy"),
           _evt("void cell_staged_kernel<LstmForward>", 70, 20, pid=0,
                tid=7, cat="kernel")]
    assert profiling.self_times(evs) == {
        "void cell_staged_kernel<LstmForward>": 60.0}
    # torch's trace files, plain and gzipped, are found and read
    (tmp_path / "a").mkdir()
    with gzip.open(tmp_path / "a" / "1.pt.trace.json.gz", "wt") as fp:
        json.dump({"traceEvents": evs}, fp)
    (tmp_path / "2.pt.trace.json").write_text(json.dumps(evs))
    assert profiling.find_trace_files(str(tmp_path)) == [
        str(tmp_path / "2.pt.trace.json"),
        str(tmp_path / "a" / "1.pt.trace.json.gz")]
    assert profiling.op_table(profiling.load_trace_events(
        str(tmp_path / "a" / "1.pt.trace.json.gz"))) == [
        ("void cell_staged_kernel<LstmForward>", 0.06)]


def test_torch_profiler_roundtrip(tmp_path, capsys):
    logdir = str(tmp_path / "tr")
    a = torch.ones(64, 64)
    with profiling.trace(logdir):
        (a @ a).sum().item()
    files = profiling.find_trace_files(logdir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    evs = profiling.load_trace_events(logdir)
    times = profiling.self_times(evs, lane=None)
    assert any("mm" in name for name in times)
    assert times and all(v >= 0 for v in times.values())
    profiling.print_op_table(logdir, lane=None, top=5)
    assert "TOTAL" in capsys.readouterr().out
    sink = []
    with profiling.step_timer(sink, device="cpu"):
        (a @ a).sum().item()
    assert len(sink) == 1 and sink[0] > 0


@pytest.mark.parametrize("t_steps,h,w", [(2, 8, 8), (3, 32, 48),
                                         (1, 128, 100)])
def test_snapshot_grid(tmp_path, t_steps, h, w):
    from PIL import Image
    rng = np.random.default_rng(0)
    m = mon.Monitor(str(tmp_path), enable_snapshots=True)
    names = ["<eos>", "person", "car"]
    pred = rng.random((t_steps, h, w))
    path = m.snapshot(7, pred,
                      (rng.random((t_steps, h, w)) > 0.5).astype(np.uint8),
                      pred_classes=np.arange(t_steps) % 3,
                      true_classes=np.ones(t_steps, np.int32),
                      class_names=names)
    m.close()
    assert path == str(tmp_path / "masks_epoch0007.png")
    s = mon.panel_scale(h, w)
    assert s * min(h, w) >= mon.MIN_SIDE
    want = (mon.PAD + t_steps * (w * s + mon.PAD),
            mon.PAD + 2 * (mon.TITLE_H + h * s + mon.PAD))
    assert mon.snapshot_size(t_steps, h, w) == want
    with Image.open(path) as im:
        assert im.size == want and im.mode == "RGB"
        px = np.asarray(im)
    # the first prediction panel is the coloured mask, enlarged
    y0, x0 = mon.PAD + mon.TITLE_H, mon.PAD
    panel = px[y0:y0 + h * s, x0:x0 + w * s]
    np.testing.assert_array_equal(panel[::s, ::s], mon.colorize(pred[0]))
    # the title band holds text (dark pixels on white)
    assert (px[mon.PAD:mon.PAD + mon.TITLE_H, :w * s] < 128).any()


def test_snapshot_off_and_colors(tmp_path):
    m = mon.Monitor(str(tmp_path))
    assert m.snapshot(0, np.zeros((2, 4, 4)), np.zeros((2, 4, 4))) is None
    m.close()
    assert not list(tmp_path.glob("*.png"))
    c = mon.colorize(np.array([[0.0, 0.5, 1.0, 2.0, -1.0, np.nan]]))
    assert c.dtype == np.uint8
    np.testing.assert_array_equal(c[0, 0], [68, 1, 84])      # viridis 0
    np.testing.assert_array_equal(c[0, 1], [33, 145, 140])   # viridis 0.5
    np.testing.assert_array_equal(c[0, 2], [253, 231, 37])   # viridis 1
    np.testing.assert_array_equal(c[0, 3], c[0, 2])          # clipped
    np.testing.assert_array_equal(c[0, 4], c[0, 0])
    np.testing.assert_array_equal(c[0, 5], c[0, 0])
