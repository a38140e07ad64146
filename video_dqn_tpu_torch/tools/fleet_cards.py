"""The training CLI as a fleet over every card of this machine, against
one card: N x 1 (TPU.MESH_DATA -1) and, where N is even, (N/2) x 2
(TPU.MESH_MODEL 2), with TPU.SHARD_DATASET, in device mode, at the
published config (configs/experiments/real_data/config.yml: 224 px, bf16,
global B = 256), 30 steps, the target synced every 8, a checkpoint at 30.

    python -m video_dqn_tpu_torch.tools.fleet_cards [--dataset FEATHER] [--out DIR]

Run it from the repo's root: the default dataset is the committed fixture,
tests/data/torch_qdata/data.feather (512 rows over 32 frames). Each run is
the CLI itself: one card with device cuda:0 (in bf16, and again in
float32, its convolutions in TF32 as torch's default has them), each
fleet without --coordinator, so that the CLI spawns one NCCL rank a card.
Each runs twice: timed, logging every 10 steps without a checkpoint, and
traced, logging every step. Each step's loss is read back from the EMA
the traced run logs (loss_t = (ema_t - 0.99 ema_t-1) / 0.01, ema_1 =
loss_1), and its step-30 checkpoint, loaded into a one-card TrainState,
gives each parameter's update from the seeded init. A fleet reorders the bf16 step's
roundings; the float32 run drops them. So the limits are measured: a
fleet's per-step losses within SPREAD_FACTOR times the float32 run's
largest distance from the bf16 one, and the relative L2 distance of its
update from the bf16 run's, over the whole tree and for each sharded
(head) parameter, within SPREAD_FACTOR times the float32 run's. Prints
each run's losses at steps 1, 10, 20, 30, its distances and the timed
run's ms/step over steps 11-30 (run_train's own frames_per_sec/train),
then one JSON line; raises past a limit.
chip_smoke.py phase 16 (d) runs it on a machine of two cards or more."""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import torch

from .. import train_q_network
from ..core.checkpoint import restore_checkpoint
from ..core.config import dump_yaml, load_yaml
from ..core.experiment import ExperimentConfig
from ..core.metrics import read_metrics
from ..parallel.sharding import param_specs
from ..train import dqn

ROOT = Path(__file__).resolve().parents[2]
PUBLISHED = ROOT / "configs" / "experiments" / "real_data" / "config.yml"
DATASET = "tests/data/torch_qdata/data.feather"
STEPS, TIMED_FROM = 30, 10
CUTS = {"NUM_STEPS": STEPS, "TARGET_UPDATE_INTERVAL": 8, "CHECKPOINT_INTERVAL": STEPS}
SPREAD_FACTOR = 2.0
ONE_CARD = "cuda:0"
FLOAT32 = "one card, float32"


def experiment(folder: Path, dataset: str, tpu: Dict, checkpoint: bool = True) -> str:
    """A folder whose config.yml is the published config cut to STEPS, on
    `dataset`, in device mode with the table sharded, with `tpu`'s keys;
    without a checkpoint unless `checkpoint`."""
    tree = load_yaml(PUBLISHED.read_text())
    tree.update(CUTS, DATASET=dataset, TPU={"DEVICE_DATASET": True, "SHARD_DATASET": True,
                                            **tpu})
    if not checkpoint:
        tree["CHECKPOINT_INTERVAL"] = 10 * STEPS
    folder.mkdir(parents=True)
    (folder / "config.yml").write_text(dump_yaml(tree))
    return str(folder)


def step_losses(emas: List[float]) -> List[float]:
    """Each step's loss from the EMA(0.99) logged at every step."""
    return [emas[0]] + [(b - 0.99 * a) / 0.01 for a, b in zip(emas, emas[1:])]


def cli(folder: str, one_card: bool, log_every: int) -> ExperimentConfig:
    """One run of the CLI: on cuda:0, or spawning one rank a card."""
    args = [folder, "--log-every", str(log_every)]
    if one_card:
        train_q_network.main(args, device=ONE_CARD)
    else:
        train_q_network.main(args)
    return ExperimentConfig(folder, resume=True)


def timing(folder: str, one_card: bool) -> float:
    """ms/step over steps TIMED_FROM+1 to STEPS of a run that logs every
    TIMED_FROM steps (run_train's own frames_per_sec/train; the host reads
    the loss once a window, so the card runs ahead of it within one)."""
    config = cli(folder, one_card, TIMED_FROM)
    rates = [r["value"] for r in read_metrics(config.run_dir, "frames_per_sec/train")
             if r["step"] > TIMED_FROM]
    return int(config.TPU.BATCH_SIZE) / (sum(rates) / len(rates)) * 1e3


def run(folder: str, one_card: bool) -> Dict:
    """One run of the CLI that logs every step; its per-step losses and
    each parameter's update (the step-30 checkpoint loaded into a one-card
    state, less the seeded init)."""
    config = cli(folder, one_card, 1)
    emas = [r["value"] for r in read_metrics(config.run_dir, "avg_q_loss/train")]
    state = dqn.create_train_state(config, device=ONE_CARD)
    init = {k: v.detach().double().cpu() for k, v in state.model.named_parameters()}
    dqn.load_flax_state_dict(state, restore_checkpoint(config.models_dir, STEPS))
    update = {k: v.detach().double().cpu() - init[k] for k, v in state.model.named_parameters()}
    return {"losses": step_losses(emas), "update": update, "specs": param_specs(state.model)}


def distance(got: Dict, base: Dict) -> Dict[str, float]:
    """Relative L2 distance of `got`'s update from `base`'s: over the whole
    tree ("tree") and for each sharded parameter."""
    sharded = [k for k, axis in base["specs"].items() if axis]
    out = {k: float((got["update"][k] - base["update"][k]).norm() / base["update"][k].norm())
           for k in sharded}
    num = sum(float((got["update"][k] - v).norm()) ** 2 for k, v in base["update"].items())
    den = sum(float(v.norm()) ** 2 for v in base["update"].values())
    out["tree"] = math.sqrt(num / den)
    return out


def cards() -> int:
    """The visible cards; raises with fewer than two."""
    n = torch.cuda.device_count()
    if n < 2:
        raise RuntimeError(f"the fleet needs two CUDA devices or more; {n} are visible")
    return n


def compare(out: Path, dataset: str = DATASET) -> Dict:
    n = cards()
    tpus = {"one card": {}, FLOAT32: {"COMPUTE_DTYPE": "float32"}, f"{n}x1": {"MESH_DATA": -1}}
    if n % 2 == 0:
        tpus[f"{n // 2}x2"] = {"MESH_DATA": -1, "MESH_MODEL": 2}
    got = {}
    for name, tpu in tpus.items():
        folder = out / name.replace(" ", "_").replace(",", "")
        one_card = name.startswith("one card")
        ms = timing(experiment(folder / "timed", dataset, tpu, checkpoint=False), one_card)
        got[name] = {**run(experiment(folder / "traced", dataset, tpu), one_card),
                     "ms_per_step": ms}
    base = got["one card"]
    spread_loss = max(abs(a - b) for a, b in zip(got[FLOAT32]["losses"], base["losses"]))
    spread = distance(got[FLOAT32], base)
    failed = []
    summary = {}
    for name, r in got.items():
        loss_diff = max(abs(a - b) for a, b in zip(r["losses"], base["losses"]))
        dist = distance(r, base)
        summary[name] = {"losses": [r["losses"][i - 1] for i in (1, 10, 20, 30)
                                    if i <= len(r["losses"])],
                         "loss_max_abs_diff": loss_diff, "update_distance": dist,
                         "ms_per_step": r["ms_per_step"]}
        print(f"[fleet] {name}: losses at steps 1/10/20/30 {summary[name]['losses']}, largest "
              f"|diff| from one card's {loss_diff:.3g} (float32 run's {spread_loss:.3g}); "
              f"update's relative L2 distance from one card's {dist} (float32 run's "
              f"{spread}); {r['ms_per_step']:.4f} ms/step over steps {TIMED_FROM + 1}-{STEPS} "
              f"(x{r['ms_per_step'] / base['ms_per_step']:.4f} of one card's)", flush=True)
        if name in (FLOAT32, "one card"):
            continue
        if len(r["losses"]) != STEPS or not loss_diff <= SPREAD_FACTOR * spread_loss or any(
                not dist[k] <= SPREAD_FACTOR * spread[k] for k in spread):
            failed.append(name)
    if failed:
        raise AssertionError(f"{failed} beyond {SPREAD_FACTOR} x the float32 run's spread: "
                             f"{json.dumps(summary)}")
    return {"cards": n, "spread_factor": SPREAD_FACTOR, "runs": summary}


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dataset", default=DATASET)
    parser.add_argument("--out", default="", help="the runs' folders (default: a temporary one)")
    args = parser.parse_args(argv)
    cards()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    if args.out:
        result = compare(Path(args.out), args.dataset)
    else:
        with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
            result = compare(Path(tmp), args.dataset)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
