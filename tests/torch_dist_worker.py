"""One rank of a multi-process test of the port on the CPU (gloo).
Not a test module; it imports neither JAX nor the JAX package: the
tests compute the JAX side in their own process and hand weights and
batches over in a ``.npz``.

Usage: python torch_dist_worker.py <job.json> <rank>, or from a test
``launch(job, directory)`` (or ``start`` and later ``join``), which runs
every rank on a free localhost port and returns their output.

job.json: {"port": P, "world": N, "mode": "handshake" | "step" |
"streaming", "inputs": path of an .npz, "out": directory, "cases": [...]}.

- handshake: ``initialize`` on a localhost coordinator, ``global_batch_slice``,
  ``shard_batch``, a global sum over the ranks, and the (dcn, data)
  grids of ``create_multislice_mesh``; prints ``proc <i>: OK
  global_sum=28.0``.
- step: per case {"name", "cfg", "gate", "seed", "eval", "inputs"
  (optional: the case's own .npz)}, the port's train step (or eval step)
  on this rank's rows of the global batch (inputs ``img``, ``tgt``) from
  the weights ``enc.*`` / ``dec.*``; writes ``<name>_rank<i>.npz`` with
  the metrics and every state_dict entry.
- streaming: per case {"name", "cfg", "T", "inputs" (optional: the
  case's own .npz)}, the H-sharded forward on the input ``x`` (B, H, W, 3)
  from the weights; writes ``<name>_rank<i>.npz`` with this rank's masks,
  the class and stop scores.
"""

import json
import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rsis_tpu_torch.config import Config  # noqa: E402
from rsis_tpu_torch.parallel import (create_mesh,  # noqa: E402
                                     create_multislice_mesh,
                                     global_batch_slice, initialize,
                                     shard_batch, shutdown)


def _weights(inputs):
    enc = {k[4:]: torch.from_numpy(inputs[k]) for k in inputs.files
           if k.startswith("enc.")}
    dec = {k[4:]: torch.from_numpy(inputs[k]) for k in inputs.files
           if k.startswith("dec.")}
    return enc, dec


def handshake(job, rank, group):
    world = job["world"]
    per, off = global_batch_slice(8)
    assert (per, off) == (8 // world, 8 // world * rank), (per, off)
    rows = shard_batch(group, (np.arange(8, dtype=np.float32),))[0]
    assert rows.tolist() == list(range(off, off + per)), rows
    total = group.all_reduce_(torch.from_numpy(rows.copy()).sum())
    assert float(total) == 28.0, float(total)
    for slices, per_slice in ((2, 1), (1, 2)):
        grid = create_multislice_mesh(slices, per_slice, device="cpu")
        assert grid.mesh.mesh_dim_names == ("dcn", "data")
        assert tuple(grid.mesh.shape) == (slices, per_slice)
        i, j = grid.mesh.get_coordinate()
        assert grid.rank == i * per_slice + j == rank, (grid.rank, rank)
        got = grid.all_reduce_(torch.tensor([float(rank + 1)]))
        assert float(got) == 3.0, float(got)
        part = shard_batch(grid, (np.arange(8),))[0]
        assert part.tolist() == list(range(4 * rank, 4 * rank + 4))
    print(f"proc {rank}: OK global_sum={float(total)}", flush=True)


def step(job, rank, group, inputs):
    from rsis_tpu_torch.train import step as port_step
    for case in job["cases"]:
        data = np.load(case["inputs"]) if "inputs" in case else inputs
        weights = _weights(data)
        batch = shard_batch(group, (data["img"], data["tgt"]))
        cfg = Config(**case["cfg"])
        state = port_step.create_train_state(cfg, weights, device="cpu")
        train_step, eval_step = port_step.make_train_step(
            cfg, T=cfg.maxseqlen, group=group)
        flags = port_step.StepFlags(1.0, 1.0, case["gate"])
        rng = (None if case.get("seed") is None
               else torch.Generator().manual_seed(case["seed"]))
        if case.get("eval"):
            metrics = eval_step(state, batch, flags, rng)
        else:
            state, metrics = train_step(state, batch, flags, rng)
        out = {"metrics": metrics.numpy()}
        for name, module in (("enc", state.encoder), ("dec", state.decoder)):
            for k, v in module.state_dict().items():
                out[f"{name}.{k}"] = v.numpy()
        np.savez(os.path.join(job["out"], f"{case['name']}_rank{rank}.npz"),
                 **out)


def streaming(job, rank, group, inputs):
    from rsis_tpu_torch.evals.streaming import make_streaming_forward
    for case in job["cases"]:
        data = np.load(case["inputs"]) if "inputs" in case else inputs
        cfg = Config(**case["cfg"])
        run = make_streaming_forward(cfg, group, T=case["T"])
        masks, clss, stops = run(_weights(data), data["x"])
        np.savez(os.path.join(job["out"], f"{case['name']}_rank{rank}.npz"),
                 masks=masks.numpy(), clss=clss.numpy(), stops=stops.numpy())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(job: dict, directory):
    """Start job's ranks (subprocesses on a free localhost port); ``join``
    waits for them."""
    job = dict(job, port=free_port(), out=str(directory))
    path = os.path.join(str(directory), f"job_{job['mode']}.json")
    with open(path, "w") as fp:
        json.dump(job, fp)
    env = dict(os.environ, OMP_NUM_THREADS=str(max(
        1, (os.cpu_count() or 2) // job["world"])))
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              path, str(i)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, env=env)
            for i in range(job["world"])]


def join(procs, timeout: float = 300) -> list:
    """Wait for the ranks of ``start`` (each within timeout seconds);
    returns their combined stdout and stderr, and raises AssertionError if
    one fails or times out."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError("ranks timed out:\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out}"
    return outs


def launch(job: dict, directory, timeout: float = 300) -> list:
    """``start`` then ``join``."""
    return join(start(job, directory), timeout)


def main() -> None:
    with open(sys.argv[1]) as fp:
        job = json.load(fp)
    rank = int(sys.argv[2])
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // job["world"]))
    assert initialize(f"127.0.0.1:{job['port']}", job["world"], rank,
                      device="cpu") == (job["world"] > 1)
    try:
        group = create_mesh(job["world"], device="cpu")
        assert (group.rank, group.size) == (rank, job["world"])
        if job["mode"] == "handshake":
            handshake(job, rank, group)
        else:
            inputs = np.load(job["inputs"]) if "inputs" in job else None
            {"step": step, "streaming": streaming}[job["mode"]](
                job, rank, group, inputs)
    finally:
        shutdown()


if __name__ == "__main__":
    main()
