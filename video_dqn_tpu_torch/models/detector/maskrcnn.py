"""Mask R-CNN, ResNet-50 FPN (counterpart of
video_dqn_tpu/models/detector/maskrcnn.py), batched over images.

  backbone.body  ResNet-50 stages C2..C5 (models/resnet.py ResNet50Stages)
  backbone.fpn   1x1 laterals + top-down sum + 3x3 output convs -> P2..P5;
                 P6 = P5[::2, ::2] (RPN only)
  rpn.head       shared 3x3 conv + 1x1 objectness and regression per level;
                 per level top-k, decode, clip, NMS; the merged top
                 proposals
  roi_heads      ROIAlign 7x7 at each proposal's FPN level -> fc6, fc7 ->
                 91 class scores and per-class box deltas (box_predictor)
                 -> per-class NMS; with masks, ROIAlign 14x14 -> 4 convs
                 -> transposed conv -> 28x28 masks (mask_head,
                 mask_predictor)

Module names are torchvision's maskrcnn_resnet50_fpn names, so that its
checkpoints load with strict=True, in the >= 0.13 naming or the legacy
flat one, which a load renames (convert.py).

Every selection stage has the JAX package's fixed shape and defaults
(1,000 candidates at each stage, 100 detections). Ties of top-k go lower
index first, as lax.top_k's do (a stable descending sort). The B images of
a call go through each stage together: the RPN's NMS of every level of
every image is one `nms_groups` call, and the final class-NMS of every
image another. Selection runs in float32 whatever the convs' type. The
two calls' order checks come out unread, as `nms_status`, so that a
forward on the card holds no host synchronize: the caller reads them with
the detections (inference.py TorchDetector.run).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..resnet import ResNet50Stages
from .boxes import clip_boxes, decode_boxes, generate_anchors, nms_groups
from .convert import rename_legacy
from .roi_align import multilevel_roi_align

STRIDES = (4, 8, 16, 32, 64)  # P2..P6
ANCHOR_SIZES = (32, 64, 128, 256, 512)
NUM_ANCHORS = 3  # aspect ratios per cell (one size per level)
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


def _conv_relu(cin: int, cout: int, k: int) -> nn.Sequential:
    """torchvision's Conv2dNormActivation without a norm: (conv, ReLU)."""
    return nn.Sequential(nn.Conv2d(cin, cout, k, padding=k // 2), nn.ReLU(inplace=True))


@lru_cache(maxsize=64)
def _nearest_index(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """Source rows of jax.image.resize(method="nearest") from n_in to
    n_out: floor((i + 0.5) * n_in / n_out) in float32 (half-pixel
    centres), where F.interpolate(mode="nearest") takes floor(i * n_in /
    n_out). They differ where n_out is not 2 * n_in (e.g. 4 -> 7)."""
    i = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
    return torch.clamp(torch.floor(i).long(), max=n_in - 1).to(device)


def upsample_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, C, h, w) -> (B, C, H, W) as jax.image.resize's nearest."""
    _, _, h, w = x.shape
    x = x.index_select(2, _nearest_index(h, size[0], x.device))
    return x.index_select(3, _nearest_index(w, size[1], x.device))


class FPN(nn.Module):
    """Feature pyramid over C2..C5 -> (P2, P3, P4, P5, P6)."""

    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels: int = 256):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, out_channels, 1)) for c in in_channels)
        self.layer_blocks = nn.ModuleList(
            nn.Sequential(nn.Conv2d(out_channels, out_channels, 3, padding=1))
            for _ in in_channels)

    def forward(self, c2, c3, c4, c5) -> tuple:
        laterals = [m(c) for m, c in zip(self.inner_blocks, (c2, c3, c4, c5))]
        p5 = laterals[3]
        p4 = laterals[2] + upsample_nearest(p5, laterals[2].shape[-2:])
        p3 = laterals[1] + upsample_nearest(p4, laterals[1].shape[-2:])
        p2 = laterals[0] + upsample_nearest(p3, laterals[0].shape[-2:])
        outs = [m(p) for m, p in zip(self.layer_blocks, (p2, p3, p4, p5))]
        return (*outs, outs[3][:, :, ::2, ::2])  # P6: a 1x1 max-pool of stride 2


class RPNHead(nn.Module):
    """Shared 3x3 conv + ReLU, then 1x1 objectness (A) and deltas (4A) per
    level."""

    def __init__(self, channels: int = 256, num_anchors: int = NUM_ANCHORS):
        super().__init__()
        self.conv = nn.Sequential(_conv_relu(channels, channels, 3))
        self.cls_logits = nn.Conv2d(channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        logits, deltas = [], []
        for f in feats:
            h = self.conv(f)
            logits.append(self.cls_logits(h))
            deltas.append(self.bbox_pred(h))
        return logits, deltas


class BoxHead(nn.Module):
    """fc6, fc7 over the flattened (C, 7, 7) pool (torchvision's
    TwoMLPHead)."""

    def __init__(self, in_features: int = 256 * 7 * 7, hidden: int = 1024):
        super().__init__()
        self.fc6 = nn.Linear(in_features, hidden)
        self.fc7 = nn.Linear(hidden, hidden)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.fc6(torch.flatten(pooled, 1)))
        return F.relu(self.fc7(x))


class BoxPredictor(nn.Module):
    """Class scores and per-class box deltas (torchvision's
    FastRCNNPredictor)."""

    def __init__(self, hidden: int = 1024, num_classes: int = 91):
        super().__init__()
        self.cls_score = nn.Linear(hidden, num_classes)
        self.bbox_pred = nn.Linear(hidden, num_classes * 4)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cls_score(x), self.bbox_pred(x)


class MaskHead(nn.Sequential):
    """Four 3x3 conv + ReLU blocks over the 14x14 pool (torchvision's
    MaskRCNNHeads)."""

    def __init__(self, channels: int = 256):
        super().__init__(*(_conv_relu(channels, channels, 3) for _ in range(4)))


class MaskPredictor(nn.Module):
    """2x2 stride-2 transposed conv + ReLU, then 1x1 class logits
    (torchvision's MaskRCNNPredictor): (R, 256, 14, 14) -> (R, 91, 28, 28)."""

    def __init__(self, channels: int = 256, num_classes: int = 91):
        super().__init__()
        self.conv5_mask = nn.ConvTranspose2d(channels, channels, 2, stride=2)
        self.mask_fcn_logits = nn.Conv2d(channels, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mask_fcn_logits(F.relu(self.conv5_mask(x)))


class RoIHeads(nn.Module):
    def __init__(self, num_classes: int = 91, with_masks: bool = False):
        super().__init__()
        self.box_head = BoxHead()
        self.box_predictor = BoxPredictor(num_classes=num_classes)
        if with_masks:
            self.mask_head = MaskHead()
            self.mask_predictor = MaskPredictor(num_classes=num_classes)

    def box_scores(self, pooled: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(R, C, 7, 7) -> class logits (R, classes), deltas (R, classes*4):
        the JAX package's BoxHead."""
        return self.box_predictor(self.box_head(pooled))

    def mask_logits(self, pooled: torch.Tensor) -> torch.Tensor:
        """(R, C, 14, 14) -> (R, classes, 28, 28): the JAX package's MaskHead."""
        return self.mask_predictor(self.mask_head(pooled))


def topk_stable(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k of each row, descending, equal values lower index first (as
    lax.top_k; torch.topk promises no order on the card)."""
    values, index = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def _take(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered at index (B, K) along dim 1."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], index]


class MaskRCNN(nn.Module):
    """The detector with the JAX class's defaults: 1,000 candidates at each
    selection stage, 100 detections, RPN NMS 0.7, box NMS 0.5, score
    threshold 0.05, 91 COCO classes. forward takes normalized images (B,
    3, H, W) and returns {boxes (B, D, 4), scores (B, D), classes (B, D)
    int64, valid (B, D) bool, nms_status (B, L + 1) int32} (and masks (B,
    D, 28, 28) with with_masks), D = max_detections, invalid rows zero;
    nms_status is each NMS group's order check (the RPN's L levels, then
    the class NMS; nonzero: the group's scores were out of order or held
    NaN), unread (boxes.check_nms_status)."""

    def __init__(self, num_classes: int = 91, with_masks: bool = False,
                 pre_nms_topk: int = 1000, post_nms_topk: int = 1000,
                 rpn_nms_thresh: float = 0.7, num_proposals: int = 1000,
                 box_score_thresh: float = 0.05, box_nms_thresh: float = 0.5,
                 max_detections: int = 100, det_candidates: int = 1000):
        super().__init__()
        self.num_classes, self.with_masks = num_classes, with_masks
        self.pre_nms_topk, self.post_nms_topk = pre_nms_topk, post_nms_topk
        self.rpn_nms_thresh, self.num_proposals = rpn_nms_thresh, num_proposals
        self.box_score_thresh, self.box_nms_thresh = box_score_thresh, box_nms_thresh
        self.max_detections, self.det_candidates = max_detections, det_candidates
        self.backbone = nn.Module()
        self.backbone.body = ResNet50Stages()
        self.backbone.fpn = FPN()
        self.rpn = nn.Module()
        self.rpn.head = RPNHead()
        self.roi_heads = RoIHeads(num_classes, with_masks)
        self._register_load_state_dict_pre_hook(
            lambda state_dict, prefix, *_: rename_legacy(state_dict, prefix))

    def features(self, images: torch.Tensor) -> tuple:
        """P2..P6 of (B, 3, H, W) images."""
        return self.backbone.fpn(*self.backbone.body(images))

    def proposals(self, feats: Sequence[torch.Tensor], height: int, width: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, P, 4) float32 proposals: per level the top pre_nms_topk
        anchors by objectness, decoded, clipped and NMS'd (every level of
        every image in one nms_groups call), then the top num_proposals
        across levels; rows past the valid ones are zero boxes. Also the
        NMS groups' statuses, (B, L) int32, unread."""
        logits, deltas = self.rpn.head(feats)
        b = feats[0].shape[0]
        level_boxes, level_scores, sizes = [], [], []
        for lvl, (lg, dl) in enumerate(zip(logits, deltas)):
            _, _, fh, fw = lg.shape
            anchors = _anchors(fh, fw, lvl, lg.device)
            score = lg.permute(0, 2, 3, 1).reshape(b, -1).float()
            delta = dl.permute(0, 2, 3, 1).reshape(b, -1, 4).float()
            k = min(self.pre_nms_topk, score.shape[1])
            top_s, top_i = topk_stable(score, k)
            boxes = clip_boxes(decode_boxes(anchors[top_i], _take(delta, top_i)),
                               height, width)
            level_boxes.append(boxes)
            level_scores.append(top_s)
            sizes.append(k)
        n = max(sizes)
        pad = lambda t, v: F.pad(t, (0, 0, 0, n - t.shape[1]) if t.dim() == 3  # noqa: E731
                                 else (0, n - t.shape[1]), value=v)
        boxes = torch.stack([pad(t, 0.0) for t in level_boxes], 1)        # (B, L, n, 4)
        scores = torch.stack([pad(t, -float("inf")) for t in level_scores], 1)
        keep_out = [min(self.post_nms_topk, k) for k in sizes]
        keep, valid, status = nms_groups(boxes.reshape(-1, n, 4), scores.reshape(-1, n),
                                         self.rpn_nms_thresh, max(keep_out))
        keep = keep.view(b, len(sizes), -1).long()
        valid = valid.view(b, len(sizes), -1)
        all_boxes, all_scores = [], []
        for lvl, m in enumerate(keep_out):
            idx, ok = keep[:, lvl, :m], valid[:, lvl, :m]
            all_boxes.append(torch.where(ok[..., None], _take(level_boxes[lvl], idx), 0.0))
            all_scores.append(torch.where(ok, _take(level_scores[lvl], idx), -float("inf")))
        proposals, pscores = torch.cat(all_boxes, 1), torch.cat(all_scores, 1)
        _, idx = topk_stable(pscores, min(self.num_proposals, pscores.shape[1]))
        return _take(proposals, idx), status.view(b, len(sizes))

    def detect(self, feats: Sequence[torch.Tensor], proposals: torch.Tensor,
               height: int, width: int) -> Dict[str, torch.Tensor]:
        """The box head on the proposals, per-class decode and clip, the
        score threshold, the top det_candidates, and the per-class NMS
        (torchvision's class offset, from each image's own largest
        coordinate) of every image in one nms_groups call, whose statuses
        come out unread as nms_status (B, 1)."""
        b, r, _ = proposals.shape
        c = self.num_classes
        pooled = multilevel_roi_align(feats[:4], proposals, STRIDES[:4], 7)
        scores, bdeltas = self.roi_heads.box_scores(pooled)
        probs = torch.softmax(scores.float(), dim=-1).view(b, r, c)
        cand_scores = probs[:, :, 1:].reshape(b, -1)
        cand_deltas = bdeltas.float().view(b, r, c, 4)[:, :, 1:].reshape(b, -1, 4)
        cand_anchors = proposals.repeat_interleave(c - 1, dim=1)
        cand_boxes = clip_boxes(decode_boxes(cand_anchors, cand_deltas, BOX_WEIGHTS),
                                height, width)
        cand_scores = torch.where(cand_scores > self.box_score_thresh, cand_scores,
                                  -float("inf"))
        top_s, top_i = topk_stable(cand_scores, min(self.det_candidates,
                                                    cand_scores.shape[1]))
        top_boxes = _take(cand_boxes, top_i)
        top_classes = top_i % (c - 1) + 1
        offset = top_classes.to(top_boxes.dtype)[..., None] * (
            top_boxes.amax(dim=(1, 2)) + 1.0)[:, None, None]
        keep, valid, status = nms_groups(top_boxes + offset, top_s, self.box_nms_thresh,
                                         self.max_detections)
        keep = keep.long()
        return {"boxes": torch.where(valid[..., None], _take(top_boxes, keep), 0.0),
                "scores": torch.where(valid, _take(top_s, keep), 0.0),
                "classes": torch.where(valid, _take(top_classes, keep), 0),
                "valid": valid, "nms_status": status.view(b, 1)}

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        _, _, h, w = images.shape
        feats = self.features(images)
        proposals, rpn_status = self.proposals(feats, h, w)
        out = self.detect(feats, proposals, h, w)
        out["nms_status"] = torch.cat([rpn_status, out["nms_status"]], 1)
        if self.with_masks:
            b, d = out["valid"].shape
            pooled = multilevel_roi_align(feats[:4], out["boxes"], STRIDES[:4], 14)
            logits = self.roi_heads.mask_logits(pooled)
            picked = logits[torch.arange(b * d, device=logits.device),
                            out["classes"].reshape(-1)]
            out["masks"] = torch.sigmoid(picked.float()).view(b, d, *picked.shape[-2:])
        return out


@lru_cache(maxsize=64)
def _anchors(fh: int, fw: int, level: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(generate_anchors(fh, fw, STRIDES[level],
                                             (ANCHOR_SIZES[level],))).to(device)
