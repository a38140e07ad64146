"""The port's detector against the JAX package's, on the CPU: box ops and
NMS (keep and valid equal), ROIAlign, each module through the bridge from
JAX's converted tree, the assembled MaskRCNN at the toy and the production
selection sizes, and the torchvision checkpoint names, with the mask
head's transposed-conv fault of the JAX converter shown."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from video_dqn_tpu.models.detector import boxes as jb
from video_dqn_tpu.models.detector.roi_align import multilevel_roi_align as jax_multilevel
from video_dqn_tpu.models.detector.roi_align import roi_align as jax_roi_align
from video_dqn_tpu.models.detector.convert import convert_maskrcnn as jax_convert
from video_dqn_tpu.models.detector.maskrcnn import FPN as JaxFPN
from video_dqn_tpu.models.detector.maskrcnn import BoxHead as JaxBoxHead
from video_dqn_tpu.models.detector.maskrcnn import MaskHead as JaxMaskHead
from video_dqn_tpu.models.detector.maskrcnn import MaskRCNN as JaxMaskRCNN
from video_dqn_tpu.models.detector.maskrcnn import RPNHead as JaxRPNHead
from video_dqn_tpu.models.resnet import ResNet50Stages as JaxResNet50Stages
from video_dqn_tpu_torch.models.bridge import maskrcnn_state_dict_from_flax
from video_dqn_tpu_torch.models.detector import boxes as pb
from video_dqn_tpu_torch.models.detector import roi_align as pr
from video_dqn_tpu_torch.models.detector.convert import convert_maskrcnn
from video_dqn_tpu_torch.models.detector.inference import TorchDetector
from video_dqn_tpu_torch.models.detector.maskrcnn import MaskRCNN
from tests.torch_detector_util import seeded_maskrcnn_state_dict

TOY_HP = dict(pre_nms_topk=50, post_nms_topk=20, num_proposals=16, max_detections=8,
              det_candidates=32, rpn_nms_thresh=0.7, box_score_thresh=0.05,
              box_nms_thresh=0.5)
PROD_HP = {}  # the class defaults of both packages (asserted equal below)
ATOL_BOX_OPS = 1e-5
ATOL_MODULE = 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def nchw(x):
    return t(np.moveaxis(np.asarray(x, np.float32), -1, 1))


def nhwc(x):
    return np.moveaxis(x.detach().numpy(), 1, -1)


def box_set(rng, n, span=60.0, ties=True):
    """n seeded boxes with repeated scores, near-duplicate boxes (IoU around
    the thresholds) and some -inf scores."""
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(4, 30, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    dup = rng.choice(n, n // 4, replace=False)
    boxes[dup] = boxes[rng.permutation(dup)] + rng.normal(0, 1.5, (len(dup), 4)).astype(
        np.float32)
    scores = rng.random(n).astype(np.float32)
    if ties:
        scores[rng.choice(n, n // 3, replace=False)] = 0.5
    scores[rng.choice(n, n // 8, replace=False)] = -np.inf
    return boxes, scores


@pytest.fixture(scope="module")
def weights():
    """One seeded torchvision-named state dict (with the mask head), JAX's
    converted tree of it, and the port's state dict bridged from that tree."""
    sd = seeded_maskrcnn_state_dict(seed=0, with_masks=True)
    params, stats = jax_convert(sd, with_masks=True)
    return sd, params, stats, maskrcnn_state_dict_from_flax(params, stats)


def port_model(bridged, with_masks=False, **hp):
    model = MaskRCNN(with_masks=with_masks, **hp)
    model.load_state_dict(convert_maskrcnn(bridged, with_masks), strict=True)
    return model.eval()


def structured_image(size, seed=0):
    """tests/test_detector_full_parity.py's irregular image: a smooth
    incommensurate base and random anisotropic blobs, so that proposals do
    not come in near-tied families."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.stack([np.sin(4.3 * yy + 0.31) * np.cos(2.7 * xx + 1.1),
                    yy * xx + 0.5 * (yy - 0.37) ** 2,
                    np.cos(5.1 * (yy - 0.62 * xx))], -1)
    for _ in range(25):
        cy, cx = rng.random(2) * size
        sy, sx = 8 + rng.random(2) * 0.15 * size
        amp = rng.standard_normal(3) * 1.2
        blob = np.exp(-(((np.mgrid[0:size][:, None] - cy) / sy) ** 2
                        + ((np.mgrid[0:size][None, :] - cx) / sx) ** 2))
        img += blob[..., None].astype(np.float32) * amp.astype(np.float32)
    img += 0.05 * rng.standard_normal(img.shape).astype(np.float32)
    return img.astype(np.float32)


# -- box ops ---------------------------------------------------------------------

@pytest.mark.parametrize("level", range(5))
def test_anchors_equal(level):
    fh = fw = 128 // (4 << level) or 1
    np.testing.assert_array_equal(
        pb.generate_anchors(fh, fw + 1, 4 << level, (32 << level,)),
        jb.generate_anchors(fh, fw + 1, 4 << level, (32 << level,)))


def test_decode_encode_clip_iou_match_jax():
    rng = np.random.default_rng(1)
    anchors, _ = box_set(rng, 64, ties=False)
    deltas = rng.normal(0, 1.0, (64, 4)).astype(np.float32)
    deltas[:4, 2:] = 9.0  # past the log(1000/16) clamp
    for weights in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        got = pb.decode_boxes(t(anchors), t(deltas), weights).numpy()
        want = np.asarray(jb.decode_boxes(anchors, deltas, weights))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL_BOX_OPS)
    boxes = np.asarray(jb.decode_boxes(anchors, deltas * 0.1))
    np.testing.assert_allclose(pb.encode_boxes(t(anchors), t(boxes)).numpy(),
                               np.asarray(jb.encode_boxes(anchors, boxes)), atol=ATOL_BOX_OPS)
    np.testing.assert_array_equal(pb.clip_boxes(t(boxes), 40, 50).numpy(),
                                  np.asarray(jb.clip_boxes(boxes, 40, 50)))
    b2, _ = box_set(rng, 17)
    np.testing.assert_allclose(pb.box_iou(t(anchors), t(b2)).numpy(),
                               np.asarray(jb.box_iou(anchors, b2)), atol=ATOL_BOX_OPS)


@pytest.mark.parametrize("seed,n,thr,max_out", [
    (0, 40, 0.5, 40), (1, 200, 0.7, 50), (2, 300, 0.3, 300), (3, 64, 0.5, 8)])
def test_nms_keep_and_valid_equal_jax(seed, n, thr, max_out):
    boxes, scores = box_set(np.random.default_rng(seed), n)
    keep, valid = pb.nms(t(boxes), t(scores), thr, max_out)
    want_keep, want_valid = jb.nms(boxes, scores, thr, max_out)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))
    assert valid.any() and not valid.all() or max_out < n // 2


def test_nms_groups_are_independent_and_padded_with_minus_inf():
    """Groups of different real lengths in one call, each padded with -inf
    scores, keep what each keeps alone (as the RPN's levels do)."""
    rng = np.random.default_rng(4)
    sets = [box_set(rng, n) for n in (50, 31, 7)]
    n = 50
    boxes = np.zeros((3, n, 4), np.float32)
    scores = np.full((3, n), -np.inf, np.float32)
    for g, (b, s) in enumerate(sets):
        order = np.argsort(-s, kind="stable")
        boxes[g, :len(s)], scores[g, :len(s)] = b[order], s[order]
    keep, valid, _ = pb.nms_groups(t(boxes), t(scores), 0.6, 20)
    for g, (b, s) in enumerate(sets):
        order = np.argsort(-s, kind="stable")
        want_keep, want_valid = jb.nms(b[order], s[order], 0.6, 20)
        np.testing.assert_array_equal(valid[g].numpy(), np.asarray(want_valid))
        np.testing.assert_array_equal(keep[g].numpy(), np.asarray(want_keep))


def test_batched_class_nms_equal_jax():
    rng = np.random.default_rng(5)
    boxes, scores = box_set(rng, 120)
    classes = rng.integers(1, 4, 120)  # heavy overlap across classes
    keep, valid = pb.batched_class_nms(t(boxes), t(scores), t(classes), 0.5, 60)
    want_keep, want_valid = jb.batched_class_nms(boxes, scores, classes, 0.5, 60)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))


def test_nms_groups_status_on_cpu():
    """nms_groups on the CPU: the twin's keep and valid, and a zero status
    a group (the twin takes any order)."""
    boxes, scores = box_set(np.random.default_rng(8), 40)
    boxes, scores = t(boxes)[None].repeat(2, 1, 1), t(scores)[None].repeat(2, 1)
    keep, valid = pb.nms_reference(boxes, scores, 0.5, 12)
    got_keep, got_valid, status = pb.nms_groups(boxes, scores, 0.5, 12)
    assert torch.equal(got_keep, keep) and torch.equal(got_valid, valid)
    assert status.dtype == torch.int32 and status.tolist() == [0, 0]
    pb.check_nms_status(status)


class _StubMaskRCNN(torch.nn.Module):
    """Fixed detections and NMS statuses of MaskRCNN.forward's shapes."""

    def __init__(self, status: int):
        super().__init__()
        self.status = status

    def forward(self, images):
        b, d = images.shape[0], 5
        rng = np.random.default_rng(9)
        return {"boxes": t(rng.uniform(0, 100, (b, d, 4)).astype(np.float32)),
                "scores": t(rng.random((b, d)).astype(np.float32)),
                "classes": t(rng.integers(0, 91, (b, d))),
                "valid": t(rng.random((b, d)) < 0.6),
                "nms_status": torch.full((b, 6), self.status, dtype=torch.int32)}


@pytest.mark.parametrize("status", [0, 1], ids=["in-order", "out-of-order"])
def test_detector_run_reads_nms_status_after_its_copy(status):
    """TorchDetector.run raises the order error where the forward's NMS
    statuses are set, and otherwise returns the forward's detections."""
    detector = TorchDetector(_StubMaskRCNN(status), device="cpu")
    frames = np.zeros((2, 16, 16, 3), np.uint8)
    if status:
        with pytest.raises(ValueError, match="descending"):
            detector.run(frames)
        return
    got = detector.run(frames)
    want = _StubMaskRCNN(0)(torch.zeros(2))
    assert sorted(got) == ["boxes", "classes", "scores", "valid"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k].numpy())
    assert got["classes"].dtype == np.int64 and got["valid"].dtype == np.bool_


# -- ROIAlign --------------------------------------------------------------------

def test_roi_align_matches_jax():
    rng = np.random.default_rng(6)
    feat = rng.standard_normal((20, 24, 8)).astype(np.float32)
    rois, _ = box_set(rng, 30, span=90.0, ties=False)
    rois[:3] = [[-10, -5, 30, 20], [80, 70, 140, 110], [5, 5, 5.5, 5.2]]  # off the map, tiny
    for out in (7, 14):
        got = pr.roi_align(t(feat), t(rois), 0.25, out).numpy()
        want = np.asarray(jax_roi_align(feat, rois, 0.25, out))
        np.testing.assert_allclose(got, want, atol=ATOL_BOX_OPS)


def test_multilevel_roi_align_matches_jax():
    """Every level in play: ROIs from 8 to 700 px (some past the map, whose
    taps clamp), two images of different maps in one call."""
    rng = np.random.default_rng(7)
    feats = [rng.standard_normal((2, 6, 128 // s, 128 // s)).astype(np.float32)
             for s in (4, 8, 16, 32)]
    side = np.exp(rng.uniform(np.log(8), np.log(700), (2, 40)))
    xy = rng.uniform(0, 100, (2, 40, 2))
    rois = np.concatenate([xy, xy + side[..., None]], -1).astype(np.float32)
    got = pr.multilevel_roi_align([t(f) for f in feats], t(rois), (4, 8, 16, 32), 7)
    assert set(pr.roi_levels(t(rois), 4).unique().tolist()) == {0, 1, 2, 3}
    for i in range(2):
        want = np.asarray(jax_multilevel(
            tuple(np.moveaxis(f[i], 0, -1) for f in feats), rois[i], (4, 8, 16, 32), 7))
        np.testing.assert_allclose(nhwc(got[i * 40:(i + 1) * 40]), want, atol=ATOL_BOX_OPS)


# -- modules through the bridge --------------------------------------------------

@pytest.mark.parametrize("size", [128, 100], ids=["128px", "100px-uneven-upsample"])
def test_backbone_and_fpn_match_jax(weights, size):
    _, params, stats, bridged = weights
    model = port_model(bridged)
    x = np.random.default_rng(8).standard_normal((1, size, size, 3)).astype(np.float32)
    with torch.no_grad():
        c = model.backbone.body(nchw(x))
        p = model.backbone.fpn(*c)
    want_c = JaxResNet50Stages().apply(
        {"params": params["body"], "batch_stats": stats["body"]}, jnp.asarray(x))
    for got, want in zip(c, want_c):
        np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL_MODULE, rtol=0)
    want_p = JaxFPN().apply({"params": params["fpn"]}, *want_c)
    if size == 100:
        assert c[3].shape[-1] == 4 and c[2].shape[-1] == 7
    for got, want in zip(p, want_p):
        np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL_MODULE, rtol=0)


def test_rpn_box_and_mask_heads_match_jax(weights):
    _, params, _, bridged = weights
    model = port_model(bridged, with_masks=True)
    rng = np.random.default_rng(9)
    feats = [rng.standard_normal((1, s, s, 256)).astype(np.float32) for s in (16, 8, 4)]
    with torch.no_grad():
        logits, deltas = model.rpn.head([nchw(f) for f in feats])
    want_l, want_d = JaxRPNHead().apply({"params": params["rpn_head"]},
                                        [jnp.asarray(f) for f in feats])
    for got, want in zip(logits + deltas, list(want_l) + list(want_d)):
        np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL_MODULE)
    pooled = rng.standard_normal((5, 7, 7, 256)).astype(np.float32)
    with torch.no_grad():
        scores, bdeltas = model.roi_heads.box_scores(nchw(pooled))
    want_s, want_b = JaxBoxHead().apply({"params": params["box_head"]}, jnp.asarray(pooled))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_s), atol=ATOL_MODULE)
    np.testing.assert_allclose(bdeltas.numpy(), np.asarray(want_b), atol=ATOL_MODULE)
    pooled = rng.standard_normal((3, 14, 14, 256)).astype(np.float32)
    with torch.no_grad():
        masks = model.roi_heads.mask_logits(nchw(pooled))
    want_m = JaxMaskHead().apply({"params": params["mask_head"]}, jnp.asarray(pooled))
    np.testing.assert_allclose(nhwc(masks), np.asarray(want_m), atol=ATOL_MODULE)


# -- the assembled detector ------------------------------------------------------

@pytest.mark.parametrize("hp", [TOY_HP, PROD_HP], ids=["toy-128px", "production-128px"])
def test_maskrcnn_matches_jax(weights, hp):
    """Every stage at once on the structured image. At the production
    defaults P2 alone holds 3,072 anchors at 128 px, so every selection
    stage runs at 1,000 candidates."""
    _, params, stats, bridged = weights
    if hp is PROD_HP:
        defaults = MaskRCNN()
        for k, v in TOY_HP.items():
            assert getattr(defaults, k) == getattr(JaxMaskRCNN(), k), k
    img = structured_image(128)
    jax_model = JaxMaskRCNN(dtype=jnp.float32, **hp)
    want = jax.device_get(jax.jit(lambda im: jax_model.apply(
        {"params": params, "batch_stats": stats}, im))(jnp.asarray(img)))
    with torch.no_grad():
        got = port_model(bridged, **hp)(nchw(img[None]))
    valid = got["valid"][0].numpy()
    np.testing.assert_array_equal(valid, want["valid"])
    assert valid.sum() >= (4 if hp is TOY_HP else 50), "vacuous: few detections"
    np.testing.assert_array_equal(got["classes"][0].numpy(), want["classes"])
    np.testing.assert_allclose(got["scores"][0].numpy(), want["scores"], atol=SCORE_ATOL)
    assert_boxes_match(got["boxes"][0].numpy(), want["boxes"], want["scores"])


SCORE_ATOL, BOX_ATOL = 1e-5, 1e-3


def assert_boxes_match(got, want, scores):
    """Detection i's box within BOX_ATOL of JAX's box i, or, where JAX's
    scores tie within SCORE_ATOL (float32 noise of two conv
    implementations: at the production defaults two detections 1e-7 apart
    swap ranks), of a distinct box of that tie group."""
    unused = set(range(len(want)))
    for i in range(len(want)):
        group = [j for j in sorted(unused) if abs(scores[j] - scores[i]) <= SCORE_ATOL]
        match = [j for j in group if np.abs(got[i] - want[j]).max() <= BOX_ATOL]
        assert match, (i, got[i], want[i], scores[i])
        unused.remove(i if i in match else match[0])


def test_batched_images_match_one_at_a_time(weights):
    """B images in one call (one NMS call a stage) give each image's own
    detections (up to float32 reordering: the convs sum in another order at
    another batch size)."""
    bridged = weights[3]
    model = port_model(bridged, **TOY_HP)
    imgs = np.stack([structured_image(96, seed) for seed in (1, 2, 3)])
    with torch.no_grad():
        together = model(nchw(imgs))
        for i in range(3):
            alone = model(nchw(imgs[i:i + 1]))
            for k in together:
                np.testing.assert_allclose(together[k][i].numpy(), alone[k][0].numpy(),
                                           atol=1e-5, rtol=1e-5)


# -- checkpoints -----------------------------------------------------------------

@pytest.mark.parametrize("legacy", [False, True], ids=["conv2dnormactivation", "legacy"])
def test_torchvision_state_dict_loads_as_bridged_but_mask_head(weights, legacy):
    """A torchvision-named checkpoint loads with strict=True in either
    naming and gives the tensors of JAX's converted tree bridged across,
    except the mask predictor's transposed conv, whose taps the bridge
    mirrors (the JAX converter's fault, below)."""
    sd, _, _, bridged = weights
    named = seeded_maskrcnn_state_dict(seed=0, with_masks=True, legacy=legacy)
    model = MaskRCNN(with_masks=True)
    model.load_state_dict(named, strict=True)
    loaded = model.state_dict()
    assert set(loaded) == set(bridged)
    differ = [k for k in loaded if not torch.equal(loaded[k], bridged[k])]
    assert differ == ["roi_heads.mask_predictor.conv5_mask.weight"]
    no_masks = MaskRCNN()
    no_masks.load_state_dict(convert_maskrcnn(named, with_masks=False), strict=True)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        MaskRCNN().load_state_dict(named, strict=True)


def test_jax_converter_transposed_conv_mirrors_taps(weights):
    """The JAX converter's `_convdt` (video_dqn_tpu/models/detector/
    convert.py:24-26) only permutes a ConvTranspose2d weight to (kh, kw,
    in, out), and Flax's ConvTranspose then applies the taps mirrored, so
    its masks are not torchvision's. The port loaded from the torchvision
    checkpoint computes F.conv_transpose2d; bridged from JAX's tree it
    computes what JAX computes."""
    import flax.linen as nn

    sd, params, _, bridged = weights
    w = sd["roi_heads.mask_predictor.conv5_mask.weight"]
    b = sd["roi_heads.mask_predictor.conv5_mask.bias"]
    x = np.random.default_rng(10).standard_normal((2, 3, 3, 256)).astype(np.float32)
    torchvision_out = nhwc(F.conv_transpose2d(nchw(x), w, b, stride=2))
    jax_out = np.asarray(nn.ConvTranspose(256, (2, 2), strides=(2, 2)).apply(
        {"params": params["mask_head"]["conv5_mask"]}, jnp.asarray(x)))
    assert np.abs(jax_out - torchvision_out).max() > 0.1  # the fault

    loaded = MaskRCNN(with_masks=True)
    loaded.load_state_dict(sd, strict=True)
    from_tree = port_model(bridged, with_masks=True)
    with torch.no_grad():
        got_loaded = nhwc(loaded.roi_heads.mask_predictor.conv5_mask(nchw(x)))
        got_tree = nhwc(from_tree.roi_heads.mask_predictor.conv5_mask(nchw(x)))
    np.testing.assert_allclose(got_loaded, torchvision_out, atol=1e-5)
    np.testing.assert_allclose(got_tree, jax_out, atol=1e-5)
