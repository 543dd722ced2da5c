"""The [yolo] head of the YOLOv3 detectors (``models.region.DarknetConfig``):
the three heads' decode, the objectness and score thresholds, per-class NMS
over every head's pairs together and the best ``max_det`` (box, class)
pairs.

``yolo_detect`` takes the three linear layers' int32 sums (B, 3*(5+C), g,
g), coarsest head first, on the device (on a card in channels-last memory:
the streamed kernel's output as it is) and returns ``dets`` (B, max_det, 6)
float32 (x, y, w, h, score, class; zero past the count) and ``count`` (B,)
int32. On a CUDA tensor it launches ``csrc/yolo_head.cu`` once a batch (its
note says what it computes); on a CPU tensor it runs
``yolo_detect_reference``, the same float32 arithmetic in plain torch. Any
other device, or a geometry the kernel does not take, raises: nothing
falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_cnn_torch.ops import _build
from tpu_cnn_torch.ops.region_head import _iou

ANCHORS_A_HEAD = 3
MAX_BOXES = 1 << 14  # the kernel's keys hold a candidate's number in 14 bits
MAX_CLASSES = 128
MAX_DET = 256

# kernel launches made by this wrapper in this process
launches = 0


def decode_reference(sums, shifts, layers, anchors, masks, classes: int, net: int):
    """The three heads' sums -> boxes (B, N, 4), objectness (B, N) and class
    sigmoids (B, N, C) in float32, N the boxes of every head in darknet's
    order (head by head, cell-major, anchor inner)."""
    boxes, objs, cls = [], [], []
    for t, layer, mask in zip(sums, layers, masks):
        b, _, g, _ = t.shape
        e = 5 + classes
        v = (t.to(torch.float32) * 2.0 ** -int(shifts[layer]))
        v = v.reshape(b, ANCHORS_A_HEAD, e, g * g).permute(0, 3, 1, 2).reshape(b, -1, e)
        cell = torch.arange(g * g, device=t.device).repeat_interleave(ANCHORS_A_HEAD)
        col, row = (cell % g).to(torch.float32), (cell // g).to(torch.float32)
        anc = torch.tensor([anchors[m] for m in mask], dtype=torch.float32,
                           device=t.device).repeat(g * g, 1)
        boxes.append(torch.stack([(col + torch.sigmoid(v[..., 0])) / g,
                                  (row + torch.sigmoid(v[..., 1])) / g,
                                  torch.exp(v[..., 2]) * anc[:, 0] / net,
                                  torch.exp(v[..., 3]) * anc[:, 1] / net], dim=-1))
        objs.append(torch.sigmoid(v[..., 4]))
        cls.append(torch.sigmoid(v[..., 5:]))
    return torch.cat(boxes, 1), torch.cat(objs, 1), torch.cat(cls, 1)


def yolo_detect_reference(sums, shifts, layers, anchors, masks, classes: int, net: int,
                          thresh: float, nms: float, max_det: int):
    """The plain version, in float32: ``decode_reference``; the boxes whose
    objectness passes ``thresh``, their pairs scoring o x sigmoid(c) above
    it; per frame, the pairs in the answer's order (score descending, then
    box, then class), each kept unless a kept pair of its class overlaps it
    past ``nms``, until ``max_det`` are kept -> dets (B, max_det, 6), count
    (B,) int32."""
    boxes, obj, cls = decode_reference(sums, shifts, layers, anchors, masks, classes, net)
    b, n, c = cls.shape
    scores = obj[..., None] * cls
    scores = torch.where((obj[..., None] > thresh) & (scores > thresh), scores,
                         torch.zeros_like(scores))
    dets = torch.zeros((b, max_det, 6), dtype=torch.float32, device=boxes.device)
    count = torch.zeros(b, dtype=torch.int32, device=boxes.device)
    for f in range(b):
        flat = scores[f].reshape(-1)  # pair = box * C + class: ties in order
        live = torch.nonzero(flat > 0).flatten()
        order = live[torch.sort(-flat[live], stable=True).indices]
        kept_box = torch.zeros((0, 4), dtype=torch.float32)
        kept_cls = torch.zeros(0, dtype=torch.long)
        rows = []
        for p in order.tolist():
            box, k = boxes[f, p // c], p % c
            same = kept_cls == k
            if same.any() and bool((_iou(kept_box[same], box[None]) > nms).any()):
                continue
            kept_box = torch.cat([kept_box, box[None]])
            kept_cls = torch.cat([kept_cls, torch.tensor([k])])
            rows.append(torch.cat([box, flat[p:p + 1], torch.tensor([float(k)])]))
            if len(rows) == max_det:
                break
        if rows:
            dets[f, :len(rows)] = torch.stack(rows)
        count[f] = len(rows)
    return dets, count


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("yolo_head")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.yolo_head_forward.argtypes = [p, p, p, p, p, p, p, f, p, p, p, i, i, f, f, i, i, p]
    lib.yolo_head_forward.restype = i
    lib.yolo_head_workspace_bytes.argtypes = [i]
    lib.yolo_head_workspace_bytes.restype = ctypes.c_longlong
    lib.yolo_head_error_string.argtypes = [i]
    lib.yolo_head_error_string.restype = ctypes.c_char_p
    return lib


def yolo_detect(sums, shifts: torch.Tensor, layers, anchors, masks, classes: int,
                net: int, thresh: float, nms: float, max_det: int):
    """The three heads' (B, 3*(5+C), g, g) int32 sums (a sequence, in
    darknet's head order), the shift vector read at ``layers[h]``, the
    anchors in pixels and each head's ``masks`` -> dets (B, max_det, 6)
    float32, count (B,) int32 (the module docstring)."""
    global launches
    sums = list(sums)
    if len(sums) != 3 or len(layers) != 3 or len(masks) != 3:
        raise ValueError("the [yolo] head reads three heads")
    b = sums[0].shape[0]
    for t, mask in zip(sums, masks):
        if (t.dtype != torch.int32 or t.dim() != 4 or t.shape[2] != t.shape[3]
                or t.shape[0] != b or t.shape[1] != ANCHORS_A_HEAD * (5 + classes)
                or len(mask) != ANCHORS_A_HEAD):
            raise ValueError(f"a head's sums must be (B, 3*(5+{classes}), g, g) int32 "
                             f"with a mask of 3 anchors, got {tuple(t.shape)} {t.dtype}")
    if not 1 <= max_det <= MAX_DET:
        raise ValueError(f"max_det {max_det}: need 1..{MAX_DET}")
    dev = sums[0].device
    if dev.type == "cpu":
        return yolo_detect_reference(sums, shifts, layers, anchors, masks, classes, net,
                                     thresh, nms, max_det)
    if dev.type != "cuda":
        raise ValueError(f"the [yolo] head runs on CUDA tensors (the kernel) or CPU "
                         f"tensors (its plain version), not on {dev}")
    if any(t.device != dev for t in sums) or shifts.device != dev:
        raise ValueError("the sums and shifts must be on one device")
    nhwc = [t.permute(0, 2, 3, 1) for t in sums]
    if not all(t.is_contiguous() for t in nhwc):
        raise ValueError("the sums must be in channels-last memory (the streamed "
                         "kernel's output)")
    boxes = sum(ANCHORS_A_HEAD * int(t.shape[2]) ** 2 for t in sums)
    if boxes > MAX_BOXES or classes > MAX_CLASSES:
        raise ValueError(f"the [yolo] head kernel takes at most {MAX_BOXES} boxes and "
                         f"{MAX_CLASSES} classes, got {boxes} and {classes}")
    lib = _lib()
    ws = torch.empty(b * lib.yolo_head_workspace_bytes(boxes), dtype=torch.uint8, device=dev)
    dets = torch.empty((b, max_det, 6), dtype=torch.float32, device=dev)
    count = torch.empty(b, dtype=torch.int32, device=dev)
    lay = (ctypes.c_int * 3)(*[int(v) for v in layers])
    grids = (ctypes.c_int * 3)(*[int(t.shape[2]) for t in sums])
    anc = (ctypes.c_float * 18)(*[float(v) for m in masks for a in m
                                  for v in anchors[a]])
    err = lib.yolo_head_forward(
        nhwc[0].data_ptr(), nhwc[1].data_ptr(), nhwc[2].data_ptr(), shifts.data_ptr(), lay,
        grids, anc, float(net), ws.data_ptr(), dets.data_ptr(), count.data_ptr(), b, classes,
        thresh, nms, max_det, dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"yolo_head_forward failed: cudaError {err} "
                           f"({lib.yolo_head_error_string(err).decode()})")
    launches += 1
    return dets, count
