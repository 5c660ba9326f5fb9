"""Work arithmetic from shapes alone: the least operations and bytes of a
launch of each hand-written kernel, the card's published peaks, and the bytes
REQUEST_COMM puts on the radio. Nothing here calls the program."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: float32 outside the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
F32 = 4


def least_s(flops: float, nbytes: float) -> float:
    """The least time a launch can take: the larger of its operations over
    the peak rate and its bytes over the peak bandwidth."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def level_shape(h: int, w: int, level: int) -> tuple:
    """(h, w) of pyramid level ``level`` (each level keeps every other
    pixel of the one below: ceil halving)."""
    for _ in range(level):
        h, w = (h + 1) // 2, (w + 1) // 2
    return h, w


def k1_work(agents: int, h: int, w: int) -> tuple:
    """(flops, bytes) of one FAST score + NMS launch over (agents, h, w)
    float32 images: each pixel read once and its score written once; the
    least arithmetic is the compass pre-test every pixel needs (4
    differences from the centre and 8 comparisons)."""
    px = agents * h * w
    return 12.0 * px, 2.0 * F32 * px


def k1_detect_frame(agents: int, h: int, w: int, pyramid_depth: int, tiles_h: int,
                    tiles_w: int) -> list:
    """(flops, bytes) of each K1 launch of one detection: one per detected
    pyramid level, each cropped to whole tiles."""
    out = []
    for lvl in range(pyramid_depth):
        lh, lw = level_shape(h, w, lvl)
        out.append(k1_work(agents, (lh // tiles_h) * tiles_h, (lw // tiles_w) * tiles_w))
    return out


def k2_work(features: int, agents: int, h: int, w: int, half_win: int) -> tuple:
    """(flops, bytes) of one LK level launch tracking ``features`` points
    over (agents, h, w) images, at the least any feature takes: one
    Gauss-Newton step over its window. Per window pixel: the previous
    patch and its two gradients interpolated (3 x 7), the structure tensor
    (6), the current patch interpolated (7), the residual (1) and the
    right-hand side (4). Bytes: each feature's bilinear footprint of the
    four images (previous, its two gradients, current), at most the four
    whole images, plus its point and guess in and its flow and flag out."""
    win = (2 * half_win + 1) ** 2
    foot = (2 * half_win + 2) ** 2
    flops = features * win * (3 * 7 + 6 + 7 + 1 + 4)
    images = min(features * 4 * foot * F32, 4 * agents * h * w * F32)
    return float(flops), float(images + features * (4 * 2 * F32 + 1))


def k2_frame(features: int, agents: int, h: int, w: int, lk_max_level: int,
             half_win: int) -> list:
    """(flops, bytes) of each K2 launch of one tracker frame: one per LK
    level, coarsest first."""
    return [k2_work(features, agents, *level_shape(h, w, lvl), half_win)
            for lvl in range(lk_max_level, -1, -1)]


def round_radio_bytes(agents: int, words: int, hits: int, payload_bytes: int) -> int:
    """Bytes one REQUEST_COMM round puts on the radio: every agent sends its
    VLAD (``words`` x 32 bytes) to every other, and every hit answers with
    one keyframe payload."""
    return agents * (agents - 1) * words * 32 + hits * payload_bytes
