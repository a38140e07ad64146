"""Gloo rank processes for the port's multi-rank CPU tests
(tests/test_torch_parallel.py). jax-free: a rank imports torch and the
port only.

`launch(tmp, world, jobs, **spec)` starts `world` processes of
`python -m tests.torch_parallel_ranks <spec.json> <rank>`, each with one
torch thread, joining one gloo group through a FileStore under `tmp`
(never a fixed port: test workers run side by side). Each runs the named
jobs in order on one (data, model) mesh and writes what the test reads
under `tmp`; a rank that fails fails the launch, with every rank's log.

`inverse_cli_rank` is the `fn` that tests/test_torch_inverse_fleet.py hands
to the launcher the inverse CLI calls (parallel/multihost.py initialize):
the CLI's own rank function, then what that test reads."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]


def launch(tmp: Path, world: int, jobs, timeout: float = 300, **spec) -> None:
    tmp.mkdir(parents=True, exist_ok=True)
    name = "-".join(jobs)
    path = tmp / f"{name}.json"
    path.write_text(json.dumps({"jobs": list(jobs), "world": world, "tmp": str(tmp),
                                "store": str(tmp / f"{name}.store"), **spec}))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    logs = [tmp / f"{name}.{r}.log" for r in range(world)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_parallel_ranks", str(path), str(r)],
                cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        text = "\n".join(f"--- rank {r} (exit {p.returncode})\n{log.read_text()[-3000:]}"
                         for r, (p, log) in enumerate(zip(procs, logs)))
        raise AssertionError(f"{name} on {world} ranks failed:\n{text}")


def _config(spec):
    from video_dqn_tpu_torch.core.defaults import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_dict(spec["config"])
    return cfg


def train_steps(spec, mesh, out: Path) -> None:
    """Teacher-forced steps: before step k every rank loads the whole
    state sample<k>.ckpt of spec['states'] (its shards of it), steps on its
    data slice of batch k, and the gathered state after it goes to
    out/sample<k+1>.ckpt (rank 0). Each rank writes its losses and its
    head shards as loaded from sample0."""
    from video_dqn_tpu_torch.core.checkpoint import restore_checkpoint, save_checkpoint
    from video_dqn_tpu_torch.parallel.mesh import shard_batch
    from video_dqn_tpu_torch.train import dqn

    cfg = _config(spec)
    state = dqn.create_train_state(cfg, device="cpu", mesh=mesh)
    step_fn = dqn.make_train_step(state.model, cfg)
    data = np.load(spec["batches"])
    losses, shards = [], {}
    for k in range(spec["steps"]):
        dqn.load_flax_state_dict(state, restore_checkpoint(spec["states"], k))
        if k == 0:
            shards = {n: p.detach().numpy().copy() for n, p in state.model.named_parameters()
                      if n.startswith("top")}
        batch = {key[len(f"{k}/"):]: data[key] for key in data.files if key.startswith(f"{k}/")}
        local = {key: torch.from_numpy(v) for key, v in shard_batch(mesh, batch).items()}
        losses.append(float(step_fn(state, local)["loss"]))
        tree = dqn.flax_state_dict(state)
        if mesh.rank == 0:
            save_checkpoint(str(out), k + 1, tree)
    np.savez(out / f"rank{mesh.rank}.npz", losses=np.array(losses), **shards)


def gather_grad(spec, mesh, out: Path) -> None:
    """A ShardedLinear of 256 outputs between seeded inputs and a
    replicated Linear, against the plain layer: the whole weight's, bias's
    and input's gradients (gathered), and the largest relative difference."""
    from torch import nn

    from video_dqn_tpu_torch.parallel.sharding import ShardedLinear

    g = torch.Generator().manual_seed(7)
    full, down = nn.Linear(64, 256), nn.Linear(256, 3)
    for p in (*full.parameters(), *down.parameters()):
        p.data = torch.randn(p.shape, generator=g) * 0.1
    x = torch.randn(4, 64, generator=g)
    grads = {}
    for name, layer in (("plain", full), ("sharded", ShardedLinear(full, mesh))):
        layer.zero_grad()
        xi = x.clone().requires_grad_(True)
        (down(torch.relu(layer(xi))) ** 2).sum().backward()
        grads[name] = [mesh.gather_model(layer.weight.grad) if name == "sharded" else
                       layer.weight.grad, mesh.gather_model(layer.bias.grad)
                       if name == "sharded" else layer.bias.grad, xi.grad]
    if mesh.rank == 0:
        np.savez(out / "gather_grad.npz", **{f"{name}{i}": t.numpy()
                                            for name, ts in grads.items()
                                            for i, t in enumerate(ts)})


def dataset(spec, mesh, out: Path) -> None:
    """The sharded device table's batches at spec['data_steps'] and the host-fed
    slices of a TableSource, this rank's, with the table's rows here."""
    from video_dqn_tpu_torch.data.device_dataset import DeviceDataset
    from video_dqn_tpu_torch.data.tables import TableSource, synthetic_video_tables
    from video_dqn_tpu_torch.train.dqn import _rank_batches

    tables = synthetic_video_tables(*spec["tables"], seed=3)
    dds = DeviceDataset(tables, spec["batch"], seed=3, device="cpu", mesh=mesh,
                        shard_frames=True)
    got = {"rows_here": np.array(dds.tables["frames"].shape[0]),
           "frame_rows": np.array(dds.frame_rows), "sharded": np.array(dds.sharded)}
    for step in spec["data_steps"]:
        got.update({f"{step}/{k}": v.numpy() for k, v in dds.sample(step).items()})
    stream = _rank_batches(TableSource(tables, seed=4), spec["batch"], mesh)
    for i in range(3):
        got.update({f"host{i}/{k}": v for k, v in next(stream).items()})
    np.savez(out / f"dataset{mesh.rank}.npz", **got)


def run_train_checks(spec, mesh, out: Path) -> None:
    """run_train's refusals on these ranks: a global batch the data ranks
    do not divide, and decode workers (host-fed, from the committed
    fixture's feather)."""
    from video_dqn_tpu_torch.train.dqn import run_train

    said = {}
    for key, edit in (("batch", {"TPU": {"BATCH_SIZE": 7}}),
                      ("workers", {"DATASET": "tests/data/torch_qdata/data.feather",
                                   "TPU": {"DECODE_WORKERS": 2, "DEVICE_DATASET": False}})):
        cfg = _config(spec)
        cfg.merge_from_dict(edit)
        try:
            run_train(cfg, device="cpu")
            said[key] = ""
        except ValueError as e:
            said[key] = str(e)
    if mesh.rank == 0:
        (out / "run_train_checks.json").write_text(json.dumps(said))


def inverse_train(spec, mesh, out: Path) -> None:
    """run_inverse_train on these ranks (data parallel over all of them):
    4 float32 steps at B = 8, 32 px, validating every 2 over 1 batch; rank
    0 writes the scalars and the checkpoints under out/inverse."""
    from video_dqn_tpu_torch.core.metrics import MetricsWriter
    from video_dqn_tpu_torch.data.gibson_pairs import GibsonPairBatcher
    from video_dqn_tpu_torch.train.inverse import run_inverse_train

    npy, root = spec["pairs"]
    writer = MetricsWriter(str(out / "inverse")) if mesh.rank == 0 else None
    kwargs = {**spec["inverse"], "dtype": getattr(torch, spec["inverse"]["dtype"])}
    run_inverse_train(*(GibsonPairBatcher(npy, image_root=root, image_size=32, seed=3)
                        for _ in range(2)), str(out / "inverse"), writer=writer, **kwargs,
                      device="cpu")


def mesh_errors(spec, mesh, out: Path) -> None:
    """make_mesh's messages on shapes that do not fit these ranks, and each
    rank's is_primary and primary_only."""
    from video_dqn_tpu_torch.parallel import multihost
    from video_dqn_tpu_torch.parallel.mesh import make_mesh

    (out / f"primary{mesh.rank}.json").write_text(json.dumps(
        [multihost.is_primary(), multihost.primary_only(lambda: mesh.rank)()]))

    said = []
    for shape in spec["bad_meshes"]:
        try:
            make_mesh(*shape)
            said.append("")
        except ValueError as e:
            said.append(str(e))
    if mesh.rank == 0:
        (out / "mesh_errors.json").write_text(json.dumps(said))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def inverse_cli_rank(device, args, validate_every: int, val_batches: int, tmp: str,
                     dtype: str) -> None:
    """A rank of the inverse CLI's fleet (multihost.initialize's `fn`): the
    CLI's rank function with the model in `dtype` (the CLI's
    COMPUTE_DTYPE), run from a working folder of the rank's own
    (tmp/rank<r>, so that a relative --out_dir shows which ranks write),
    then what the test reads, in tmp/rank<r>.json: the final accuracy,
    the largest difference of each trained tensor from rank 0's, and on
    rank 0 whether the last checkpoint loads equal to the state."""
    from video_dqn_tpu_torch import train_inverse_model
    from video_dqn_tpu_torch.core.checkpoint import restore_checkpoint
    from video_dqn_tpu_torch.parallel.mesh import world
    from video_dqn_tpu_torch.train.inverse import flax_state_dict

    train_inverse_model.COMPUTE_DTYPE = getattr(torch, dtype)
    rank = world()[0]
    folder = Path(tmp) / f"rank{rank}"
    folder.mkdir()
    os.chdir(folder)
    state, accuracy = train_inverse_model._rank_fn(device, args, validate_every, val_batches)
    diff = 0.0
    for p in state.model.head_parameters():
        ref = p.detach().clone()
        dist.broadcast(ref, src=0)
        diff = max(diff, float((p.detach() - ref).abs().max()))
    said = {"accuracy": accuracy, "step": state.step, "diff_to_rank0": diff}
    if rank == 0:
        saved = dict(_leaves(restore_checkpoint(args.out_dir, state.step)))
        live = dict(_leaves(flax_state_dict(state)))
        said["checkpoint_equal"] = saved.keys() == live.keys() and all(
            np.array_equal(saved[k], live[k]) for k in live)
    (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(said))


JOBS = {"train_steps": train_steps, "gather_grad": gather_grad, "dataset": dataset,
        "mesh_errors": mesh_errors, "run_train_checks": run_train_checks,
        "inverse_train": inverse_train}


def main() -> None:
    spec = json.loads(Path(sys.argv[1]).read_text())
    rank = int(sys.argv[2])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}",
                            world_size=spec["world"], rank=rank)
    try:
        from video_dqn_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(*spec["mesh"])
        out = Path(spec["tmp"])
        for job in spec["jobs"]:
            JOBS[job](spec, mesh, out)
            dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
