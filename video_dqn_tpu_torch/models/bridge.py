"""Weights between the port and the JAX package's Flax layout, both ways,
and the reference's `.torch` checkpoints.

The port's state dict uses the reference's naming, which is also the
port's HabitatDQN naming: `resnet.*` (torchvision), the trunk again under
`features.{0,1,4,5,6,7}`, the head conv `features.8`, and `top.{0,2,4}`
(or `top` for the basic head). One table (`_entries`) pairs each torch
tensor with its Flax leaf and the layout change between them; both
directions read it:
  * conv kernels OIHW <-> HWIO; dense kernels (out, in) <-> (in, out);
  * the first head dense reads a flattened map: Flax flattens each frame
    as (H, W, C), torch as (C, H, W), so its input columns are re-ordered
    per frame block;
  * BatchNorm weight/bias <-> scale/bias (params), running stats <->
    mean/var (batch_stats).
Adam's moments change layout as their parameters do, so optax's
`{count, mu, nu}` maps onto torch.optim.Adam's (or AdamW's) per-parameter
`step`/`exp_avg`/`exp_avg_sq` through the same table (`adam_to_optax`,
`adam_from_optax`); `chain_to_optax` and `chain_from_optax` add the links
of the inverse trainer's chains, optax.adam(schedule) and
optax.adamw(schedule, wd).

The detector (models/detector/maskrcnn.py) has a table too
(`_maskrcnn_entries`, read by `maskrcnn_state_dict_from_flax`): the
ResNet-50 body, FPN, RPN head, box head (fc6 with the (7, 7, 256) <->
(256, 7, 7) reorder) and optional mask head of the JAX package's MaskRCNN
tree, under torchvision's names. Its transposed conv's taps are mirrored
on the way: Flax's ConvTranspose (transpose_kernel=False) applies its
kernel unflipped, where torch's ConvTranspose2d flips it.

The inverse model (models/inverse.py) has a table of its own
(`_inverse_entries`): the trunk as `resnet18.{0,1,4,5,6,7}.*` under the
Flax `resnet`, the head convs, `fc1` with the same (H, W, C) <-> (C, H, W)
reorder at its map's size, `fc2` and `fc_accuracy`. `entries(model)`
gives either model's table.

The Places365 AlexNet (models/alexnet_places.py) has the smallest table
(`_alexnet_entries`, read by `alexnet_state_dict_from_flax`): the five
convs and three denses of the JAX package's AlexNetPlaces365 under
torchvision's `features.*` and `classifier.*` names, fc6 with the (6, 6,
256) <-> (256, 6, 6) reorder.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, NamedTuple, Tuple

import numpy as np
import torch

from .inverse import InverseActionModel, head_side
from .qnet import head_hw

# index of each trunk module in the reference's `features` Sequential
_FEATURE_INDEX = {"conv1": 0, "bn1": 1, "layer1": 4, "layer2": 5,
                  "layer3": 6, "layer4": 7}


def _sequential(name: str) -> str:
    """A torchvision trunk name (`conv1.weight`, `layer1.0.bn1.bias`) under
    the trunk's index in a Sequential of torchvision's children."""
    head, _, rest = name.partition(".")
    return f"{_FEATURE_INDEX[head]}.{rest}"


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))  # a copy: leaves may be read-only


def _same(a: np.ndarray) -> np.ndarray:
    return a


def _conv_to_torch(k: np.ndarray) -> np.ndarray:
    return k.transpose(3, 2, 0, 1)  # HWIO -> OIHW


def _conv_to_flax(w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 3, 1, 0)  # OIHW -> HWIO


def _transpose(k: np.ndarray) -> np.ndarray:
    return k.T  # dense (in, out) <-> (out, in)


def _hwc_dense(c: int, h: int, w: int, frames: int) -> Tuple[Callable, Callable]:
    """The head's first dense: Flax rows ordered (frame, h, w, c) <-> torch
    columns ordered (frame, c, h, w)."""
    def to_torch(k: np.ndarray) -> np.ndarray:
        if k.shape[0] != frames * h * w * c:
            raise ValueError(f"head dense has {k.shape[0]} inputs, expected "
                             f"{frames}*{h}*{w}*{c}")
        out_dim = k.shape[1]
        blocks = k.T.reshape(out_dim, frames, h, w, c).transpose(0, 1, 4, 2, 3)
        return blocks.reshape(out_dim, frames * c * h * w)

    def to_flax(m: np.ndarray) -> np.ndarray:
        out_dim = m.shape[0]
        blocks = m.reshape(out_dim, frames, c, h, w).transpose(0, 1, 3, 4, 2)
        return blocks.reshape(out_dim, frames * h * w * c).T

    return to_torch, to_flax


class _Entry(NamedTuple):
    collection: str          # "params" or "batch_stats"
    name: str                # torch state-dict name
    path: Tuple[str, ...]    # Flax tree path
    to_torch: Callable
    to_flax: Callable


_CONV = (_conv_to_torch, _conv_to_flax)
_DENSE = (_transpose, _transpose)
_VEC = (_same, _same)


def _bn(torch_name: str, flax_path: Tuple[str, ...]) -> List[_Entry]:
    return [_Entry("params", f"{torch_name}.weight", flax_path + ("scale",), *_VEC),
            _Entry("params", f"{torch_name}.bias", flax_path + ("bias",), *_VEC),
            _Entry("batch_stats", f"{torch_name}.running_mean", flax_path + ("mean",), *_VEC),
            _Entry("batch_stats", f"{torch_name}.running_var", flax_path + ("var",), *_VEC)]


def _trunk() -> List[_Entry]:
    """ResNet18 without `fc`: torchvision names, Flax paths under the
    trunk. The first block of stages 2-4 has the 1x1 projection."""
    out = [_Entry("params", "conv1.weight", ("conv1", "kernel"), *_CONV)] + _bn("bn1", ("bn1",))
    for stage in range(1, 5):
        for block in range(2):
            t, f = f"layer{stage}.{block}", f"layer{stage}_{block}"
            out.append(_Entry("params", f"{t}.conv1.weight", (f, "conv1", "kernel"), *_CONV))
            out += _bn(f"{t}.bn1", (f, "bn1"))
            out.append(_Entry("params", f"{t}.conv2.weight", (f, "conv2", "kernel"), *_CONV))
            out += _bn(f"{t}.bn2", (f, "bn2"))
            if stage > 1 and block == 0:
                out.append(_Entry("params", f"{t}.downsample.0.weight",
                                  (f, "downsample_conv", "kernel"), *_CONV))
                out += _bn(f"{t}.downsample.1", (f, "downsample_bn"))
    return out


def _entries(extra_capacity: bool, num_frames: int,
             head_hw: Tuple[int, int]) -> List[_Entry]:
    """Every tensor of the Q-net once, under its `resnet.*` / head name."""
    out = [e._replace(name=f"resnet.{e.name}", path=("resnet",) + e.path) for e in _trunk()]
    if extra_capacity:
        out += [_Entry("params", "features.8.weight", ("head_conv", "kernel"), *_CONV),
                _Entry("params", "features.8.bias", ("head_conv", "bias"), *_VEC),
                _Entry("params", "top.0.weight", ("top_dense1", "kernel"),
                       *_hwc_dense(64, head_hw[0], head_hw[1], num_frames)),
                _Entry("params", "top.0.bias", ("top_dense1", "bias"), *_VEC)]
        for i, name in ((2, "top_dense2"), (4, "top_dense3")):
            out += [_Entry("params", f"top.{i}.weight", (name, "kernel"), *_DENSE),
                    _Entry("params", f"top.{i}.bias", (name, "bias"), *_VEC)]
    else:
        out += [_Entry("params", "top.weight", ("top_dense1", "kernel"), *_DENSE),
                _Entry("params", "top.bias", ("top_dense1", "bias"), *_VEC)]
    return out


def _inverse_entries(side: int) -> List[_Entry]:
    """Every tensor of the inverse model once, under its reference name;
    `side` is the map fc1 flattens (3 at 224 px)."""
    out = [e._replace(name=f"resnet18.{_sequential(e.name)}", path=("resnet",) + e.path)
           for e in _trunk()]
    for conv in ("conv1", "conv2", "conv3"):
        out += [_Entry("params", f"{conv}.weight", (conv, "kernel"), *_CONV),
                _Entry("params", f"{conv}.bias", (conv, "bias"), *_VEC)]
    for dense, maps in (("fc1", _hwc_dense(64, side, side, 1)), ("fc2", _DENSE),
                        ("fc_accuracy", _DENSE)):
        out += [_Entry("params", f"{dense}.weight", (dense, "kernel"), *maps),
                _Entry("params", f"{dense}.bias", (dense, "bias"), *_VEC)]
    return out


def _convt_to_torch(k: np.ndarray) -> np.ndarray:
    # Flax (kh, kw, in, out) -> torch (in, out, kh, kw), taps mirrored
    return np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1))


def _convt_to_flax(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 0, 1)[::-1, ::-1])


def _conv_bias(torch_name: str, flax_path: Tuple[str, ...]) -> List[_Entry]:
    return [_Entry("params", f"{torch_name}.weight", flax_path + ("kernel",), *_CONV),
            _Entry("params", f"{torch_name}.bias", flax_path + ("bias",), *_VEC)]


def _dense_bias(torch_name: str, flax_path: Tuple[str, ...], maps=_DENSE) -> List[_Entry]:
    return [_Entry("params", f"{torch_name}.weight", flax_path + ("kernel",), *maps),
            _Entry("params", f"{torch_name}.bias", flax_path + ("bias",), *_VEC)]


def _maskrcnn_entries(with_masks: bool) -> List[_Entry]:
    """Every tensor of the port's MaskRCNN once, under torchvision's
    (>= 0.13) name, with its path in the JAX package's MaskRCNN tree."""
    body = "backbone.body"
    out = [_Entry("params", f"{body}.conv1.weight", ("body", "conv1", "kernel"), *_CONV)]
    out += _bn(f"{body}.bn1", ("body", "bn1"))
    for stage, n_blocks in enumerate((3, 4, 6, 3), start=1):
        for block in range(n_blocks):
            t, f = f"{body}.layer{stage}.{block}", ("body", f"layer{stage}_{block}")
            for c in (1, 2, 3):
                out.append(_Entry("params", f"{t}.conv{c}.weight", f + (f"conv{c}", "kernel"),
                                  *_CONV))
                out += _bn(f"{t}.bn{c}", f + (f"bn{c}",))
            if block == 0:
                out.append(_Entry("params", f"{t}.downsample.0.weight",
                                  f + ("downsample_conv", "kernel"), *_CONV))
                out += _bn(f"{t}.downsample.1", f + ("downsample_bn",))
    for i in range(4):
        out += _conv_bias(f"backbone.fpn.inner_blocks.{i}.0", ("fpn", f"inner{i}"))
        out += _conv_bias(f"backbone.fpn.layer_blocks.{i}.0", ("fpn", f"layer{i}"))
    out += _conv_bias("rpn.head.conv.0.0", ("rpn_head", "conv"))
    out += _conv_bias("rpn.head.cls_logits", ("rpn_head", "cls_logits"))
    out += _conv_bias("rpn.head.bbox_pred", ("rpn_head", "bbox_pred"))
    out += _dense_bias("roi_heads.box_head.fc6", ("box_head", "fc6"), _hwc_dense(256, 7, 7, 1))
    out += _dense_bias("roi_heads.box_head.fc7", ("box_head", "fc7"))
    out += _dense_bias("roi_heads.box_predictor.cls_score", ("box_head", "cls_score"))
    out += _dense_bias("roi_heads.box_predictor.bbox_pred", ("box_head", "bbox_pred"))
    if with_masks:
        for i in range(4):
            out += _conv_bias(f"roi_heads.mask_head.{i}.0", ("mask_head", f"mask_fcn{i + 1}"))
        out += [_Entry("params", "roi_heads.mask_predictor.conv5_mask.weight",
                       ("mask_head", "conv5_mask", "kernel"), _convt_to_torch, _convt_to_flax),
                _Entry("params", "roi_heads.mask_predictor.conv5_mask.bias",
                       ("mask_head", "conv5_mask", "bias"), *_VEC)]
        out += _conv_bias("roi_heads.mask_predictor.mask_fcn_logits",
                          ("mask_head", "mask_fcn_logits"))
    return out


def entries(model) -> List[_Entry]:
    """The table of a port HabitatDQN or InverseActionModel."""
    if isinstance(model, InverseActionModel):
        return _inverse_entries(head_side(model.image_size))
    return _entries(*layout(model))


def layout(model) -> Tuple[bool, int, Tuple[int, int]]:
    """(extra_capacity, num_frames, head_hw) of a port HabitatDQN: the
    arguments every conversion here takes."""
    side = head_hw(model.image_size)
    return model.extra_capacity, model.num_frames, (side, side)


def _get(tree: Mapping, path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def _put(tree: Dict, path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _from_table(tree: Mapping, collection: str, table: List[_Entry]) -> Dict[str, torch.Tensor]:
    return {e.name: _t(e.to_torch(np.asarray(_get(tree, e.path))))
            for e in table if e.collection == collection}


def _to_table(named: Mapping[str, torch.Tensor], collection: str, table: List[_Entry]) -> Dict:
    tree: Dict = {}
    for e in table:
        if e.collection == collection:
            a = named[e.name].detach().to("cpu", torch.float32).numpy()
            _put(tree, e.path, np.array(e.to_flax(a), order="C"))  # a copy, not a view
    return tree


def from_flax(tree: Mapping, collection: str, extra_capacity: bool, num_frames: int,
              head_hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
    """A Flax `collection` tree (params-shaped for params and Adam moments,
    or batch_stats) -> {torch name: float32 tensor}, one name per tensor
    (`resnet.*`, no `features.*` aliases)."""
    return _from_table(tree, collection, _entries(extra_capacity, num_frames, head_hw))


def to_flax(named: Mapping[str, torch.Tensor], collection: str, extra_capacity: bool,
            num_frames: int, head_hw: Tuple[int, int]) -> Dict:
    """{torch name: tensor} (a state dict, named parameters, their
    gradients or Adam moments) -> the Flax `collection` tree of float32
    numpy arrays, copies of the tensors. Reads the `resnet.*` and head
    names only."""
    return _to_table(named, collection, _entries(extra_capacity, num_frames, head_hw))


def model_to_flax(named: Mapping[str, torch.Tensor], collection: str, model) -> Dict:
    """to_flax with `model`'s table (either model)."""
    return _to_table(named, collection, entries(model))


def _with_bn_counters(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    for k in [k for k in sd if k.endswith(".running_var")]:
        sd[k.replace(".running_var", ".num_batches_tracked")] = torch.tensor(0)
    return sd


def qnet_state_dict_from_flax(params: Mapping, batch_stats: Mapping,
                              extra_capacity: bool, num_frames: int,
                              head_hw: Tuple[int, int] = (5, 5)
                              ) -> Dict[str, torch.Tensor]:
    """Flax HabitatDQN (params, batch_stats), as numpy trees, -> the port's
    (and the reference's) state dict. `head_hw` is the extra_capacity head
    map: (5, 5) at 224 px, (2, 2) at 128, (1, 1) at 96."""
    geometry = (extra_capacity, num_frames, head_hw)
    sd = _with_bn_counters({**from_flax(params, "params", *geometry),
                            **from_flax(batch_stats, "batch_stats", *geometry)})
    for k in [k for k in sd if k.startswith("resnet.")]:
        sd[f"features.{_sequential(k[len('resnet.'):])}"] = sd[k]
    return sd


def flax_from_qnet_state_dict(sd: Mapping[str, torch.Tensor], extra_capacity: bool,
                              num_frames: int, head_hw: Tuple[int, int] = (5, 5)
                              ) -> Tuple[Dict, Dict]:
    """The inverse of qnet_state_dict_from_flax: a port state dict ->
    Flax (params, batch_stats) as numpy trees."""
    geometry = (extra_capacity, num_frames, head_hw)
    return to_flax(sd, "params", *geometry), to_flax(sd, "batch_stats", *geometry)


def inverse_state_dict_from_flax(params: Mapping, batch_stats: Mapping,
                                 image_size: int) -> Dict[str, torch.Tensor]:
    """Flax InverseActionModel (params, batch_stats), as numpy trees, ->
    the port's (and the reference's) state dict for `image_size` images."""
    table = _inverse_entries(head_side(image_size))
    return _with_bn_counters({**_from_table(params, "params", table),
                              **_from_table(batch_stats, "batch_stats", table)})


def flax_from_inverse_state_dict(sd: Mapping[str, torch.Tensor],
                                 image_size: int) -> Tuple[Dict, Dict]:
    """The inverse of inverse_state_dict_from_flax."""
    table = _inverse_entries(head_side(image_size))
    return _to_table(sd, "params", table), _to_table(sd, "batch_stats", table)


def _whole(name: str, t: torch.Tensor) -> torch.Tensor:
    return t


def adam_to_optax(optimizer: torch.optim.Adam, model, full: Callable = _whole) -> Dict:
    """torch.optim.Adam's (or AdamW's) state over `model`'s parameters ->
    optax ScaleByAdamState as a Flax state dict: {count (int32), mu, nu}.
    Before the first step Adam holds no state: count 0, zero moments.
    `full(name, moment)` gives a sharded parameter's whole moment."""
    named = dict(model.named_parameters())
    states = [optimizer.state.get(p, {}) for p in named.values()]
    counts = {int(s["step"]) for s in states if s}
    if len(counts) > 1 or (counts and len(states) != sum(bool(s) for s in states)):
        raise ValueError(f"parameters are at different Adam steps: {sorted(counts)}")
    count = counts.pop() if counts else 0
    moments = {}
    for key, field in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        moments[key] = model_to_flax(
            {n: full(n, s[field] if s else torch.zeros_like(p))
             for (n, p), s in zip(named.items(), states)},
            "params", model)
    return {"count": np.asarray(count, np.int32), **moments}


def adam_from_optax(optimizer: torch.optim.Adam, model, opt_state: Mapping,
                    local: Callable = _whole) -> None:
    """Load an optax ScaleByAdamState state dict ({count, mu, nu}) into
    torch.optim.Adam's per-parameter state, in place. `local(name,
    moment)` gives a sharded parameter's shard of a whole moment."""
    count = int(np.asarray(opt_state["count"]))
    mu = _from_table(opt_state["mu"], "params", entries(model))
    nu = _from_table(opt_state["nu"], "params", entries(model))
    mu, nu = ({n: local(n, t) for n, t in m.items()} for m in (mu, nu))
    for name, p in model.named_parameters():
        if mu[name].shape != p.shape:
            raise ValueError(f"Adam moment {name}: {tuple(mu[name].shape)} "
                             f"vs parameter {tuple(p.shape)}")
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.zeros_like(p).copy_(mu[name]),
            "exp_avg_sq": torch.zeros_like(p).copy_(nu[name]),
        }


def chain_to_optax(optimizer: torch.optim.Optimizer, model, schedule_count: int) -> Dict:
    """The state of optax.adam(schedule), ({count, mu, nu}, {count}), or of
    optax.adamw(schedule, wd), which adds the empty add_decayed_weights
    link between them, as Flax serializes the tuple: {"0": ..., "1": ...}.
    AdamW is the chain with the extra link."""
    links = [adam_to_optax(optimizer, model)]
    if isinstance(optimizer, torch.optim.AdamW):
        links.append({})
    links.append({"count": np.asarray(schedule_count, np.int32)})
    return {str(k): link for k, link in enumerate(links)}


def chain_from_optax(optimizer: torch.optim.Optimizer, model, opt_state: Mapping) -> None:
    """Load chain_to_optax's layout into the optimizer, in place. The
    chain's length must be the optimizer's."""
    want = 3 if isinstance(optimizer, torch.optim.AdamW) else 2
    if len(opt_state) != want:
        raise ValueError(f"an optax chain of {len(opt_state)} links does not fit "
                         f"{type(optimizer).__name__} ({want} links)")
    adam_from_optax(optimizer, model, opt_state["0"])


def sequential_trunk(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torchvision-named trunk state dict (`conv1.*`, `layer1.*`, ...)
    under the indices of the trunk's Sequential (`0.*`, `4.*`, ...), as the
    inverse model's `resnet18` holds it."""
    return {_sequential(k): v for k, v in sd.items()}


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a torch checkpoint file, unwrapping the reference's
    {'model_state_dict': ...} snapshot format when present. Tensors and
    plain containers only (weights_only)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        blob = blob["model_state_dict"]
    return dict(blob)


def maskrcnn_state_dict_from_flax(params: Mapping, batch_stats: Mapping
                                  ) -> Dict[str, torch.Tensor]:
    """The JAX package's MaskRCNN (params, batch_stats), as numpy trees, ->
    the port's MaskRCNN state dict (torchvision's names); the mask head's
    tensors when the tree has a mask head."""
    table = _maskrcnn_entries("mask_head" in params)
    return {**_from_table(params, "params", table),
            **_from_table(batch_stats, "batch_stats", table)}


def _alexnet_entries() -> List[_Entry]:
    """Every tensor of the port's AlexNetPlaces365 under torchvision's name,
    with its path in the JAX package's AlexNetPlaces365 tree."""
    out: List[_Entry] = []
    for name, index in (("conv1", 0), ("conv2", 3), ("conv3", 6), ("conv4", 8), ("conv5", 10)):
        out += _conv_bias(f"features.{index}", (name,))
    out += _dense_bias("classifier.1", ("fc6",), _hwc_dense(256, 6, 6, 1))
    out += _dense_bias("classifier.4", ("fc7",))
    out += _dense_bias("classifier.6", ("fc8",))
    return out


def alexnet_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's AlexNetPlaces365 params, as a numpy tree, -> the
    port's AlexNetPlaces365 state dict (torchvision's names)."""
    return _from_table(params, "params", _alexnet_entries())
