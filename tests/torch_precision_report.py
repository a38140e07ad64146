"""How far apart the port's and the JAX package's training numbers lie in
float32, and how far each lies from its own float64: the measurements
behind the tolerances of tests/test_torch_train.py. Runs on the CPU in
about two minutes:

    JAX_PLATFORMS=cpu python -m tests.torch_precision_report

Prints, per architecture, the largest leaf error of each pair of
gradients (max |a - b| over the largest float64 JAX gradient of the
leaf) with its leaf, the port's float32 gradient against its float64 one
at several CPU thread counts, and the distance of the port's parameter
update from JAX's at each step of the 4-step trace (update_distance)."""

import numpy as np
import torch

from tests import test_torch_train as T
from video_dqn_tpu_torch.train import dqn

THREADS = (1, 2, torch.get_num_threads())


def worst_leaf(a, b, scale_tree):
    """(max over leaves of max |a - b| / max |scale leaf|, that leaf)."""
    errs = []
    for (path, x, s), (_, y, _) in zip(T.leaf_pairs(a, scale_tree), T.leaf_pairs(b, scale_tree)):
        errs.append((float(np.abs(x - y).max() / np.abs(s).max()),
                     "/".join(k.key for k in path)))
    return max(errs)


def update_distances(trace):
    pcfg, data, _, states = trace
    state = dqn.create_train_state(pcfg, device="cpu")
    step_fn = dqn.make_train_step(state.model, pcfg)
    out = []
    for k, b in enumerate(data):
        dqn.load_flax_state_dict(state, states[k])
        step_fn(state, T.torch_batch(b))
        out.append(T.update_distance(states[k]["params"], dqn.flax_state_dict(state)["params"],
                                     states[k + 1]["params"]))
    return ", ".join(f"{d:.3g}" for d in out)


def main():
    for arch in T.GRAD_DTYPE:
        grads = {"jax32": T.jax_grads(arch, "float32"), "jax64": T.jax_grads(arch, "float64"),
                 "port32": T.port_grads(arch), "port64": T.port_grads(arch, "float64")}
        scale = grads["jax64"]
        for a, b in (("jax32", "jax64"), ("port32", "port64"), ("port64", "jax64"),
                     ("port32", "jax32"), ("port32", "jax64")):
            err, leaf = worst_leaf(grads[a], grads[b], scale)
            print(f"{arch} gradient {a} vs {b}: {err:.3g} ({leaf})")
        trace = T.run_jax_trace(arch)
        default = torch.get_num_threads()
        for n in THREADS:
            torch.set_num_threads(n)
            err, leaf = worst_leaf(T.port_grads(arch), grads["port64"], scale)
            print(f"{arch} {n} threads: gradient port32 vs port64 {err:.3g} ({leaf}); "
                  f"update distance per step {update_distances(trace)}")
        torch.set_num_threads(default)


if __name__ == "__main__":
    main()
