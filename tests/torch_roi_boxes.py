"""Box sets for the ROIAlign tests (numpy only, no JAX): the geometry that the
staged-window kernel csrc/roi_align.cu finds hardest. Each returns
(B, R, 4) float32 XYXY boxes over a size x size canvas; pyramid strides
4..64, so p2 is size / 4 wide and p6 size / 64."""
import numpy as np

BOX_SETS = ("edge", "elongated", "border", "subpixel", "levels")


def edge_boxes(rng, B, R, size):
    """Random boxes plus boxes past the border, sub-pixel boxes, a zero-area
    box and huge boxes that the level heuristic clamps to p6."""
    xy = rng.uniform(-20, size, (B, R, 2))
    wh = rng.uniform(1, size * 0.7, (B, R, 2))
    b = np.concatenate([xy, xy + wh], -1)
    b[:, 0] = [-40.0, -30.0, size + 50.0, size + 60.0]     # huge, past every border
    b[:, 1] = [-5000.0, -5000.0, 5000.0, 5000.0]           # far beyond p6's scale
    b[:, 2] = [10.3, 20.6, 10.5, 20.9]                     # sub-pixel
    b[:, 3] = [7.0, 7.0, 7.0, 7.0]                         # zero area
    b[:, 4] = [size - 3.0, -8.0, size + 20.0, 6.0]         # across a corner
    return b.astype(np.float32)


def elongated_boxes(rng, B, R, size):
    """Thin RoIs that span far more than 2 * out_size * sr feature units at
    their level along one axis (a 512 x 20 px box lands on p2 with 128
    columns to span), half of them horizontal, some running past a border."""
    long = rng.uniform(0.5, 1.3, (B, R)) * size
    thin = rng.uniform(2, 16, (B, R))
    x0 = rng.uniform(-0.2, 0.6, (B, R)) * size
    y0 = rng.uniform(-0.05, 0.95, (B, R)) * size
    horiz = rng.random((B, R)) < 0.5
    w = np.where(horiz, long, thin)
    h = np.where(horiz, thin, long)
    x0, y0 = np.where(horiz, x0, y0), np.where(horiz, y0, x0)
    return np.stack([x0, y0, x0 + w, y0 + h], -1).astype(np.float32)


def border_boxes(rng, B, R, size):
    """RoIs hugging each border and corner: one edge on the border (or just
    past it, or on its last pixel), the others inside."""
    wh = rng.uniform(4, size * 0.6, (B, R, 2))
    xy = rng.uniform(0, size, (B, R, 2))
    b = np.concatenate([xy, xy + wh], -1)
    side = rng.integers(0, 4, (B, R))
    off = rng.choice([0.0, -0.5, -3.0, 0.25], (B, R))
    for s, (lo, hi) in enumerate(((0, 2), (1, 3), (2, 0), (3, 1))):
        m = side == s
        if s < 2:   # left / top edge on the border
            b[..., lo][m] = off[m]
            b[..., hi][m] = off[m] + wh[..., s % 2][m]
        else:       # right / bottom edge on the border
            b[..., lo][m] = size - off[m]
            b[..., hi][m] = size - off[m] - wh[..., s % 2][m]
    b[:, :4] = [[0.0, 0.0, 12.0, 12.0], [size - 12.0, size - 12.0, size, size],
                [size - 1.0, size - 1.0, size, size], [0.0, size - 30.0, 30.0, size]]
    return b.astype(np.float32)


def subpixel_boxes(rng, B, R, size):
    """RoIs under one feature pixel (every sample in one cell), anywhere,
    on the last pixel of a border and at the canvas corners."""
    xy = rng.uniform(-1.0, size + 1.0, (B, R, 2))
    wh = rng.uniform(0.0, 0.9, (B, R, 2))
    b = np.concatenate([xy, xy + wh], -1)
    b[:, 0] = [size - 0.6, size - 0.6, size - 0.1, size - 0.1]
    b[:, 1] = [0.0, 0.0, 0.2, 0.2]
    return b.astype(np.float32)


def level_boxes(rng, B, R, size):
    """Square RoIs sized for every level p2..p6 (~20 px to far beyond p6's
    scale), at random places, some crossing the border."""
    side = np.exp(rng.uniform(np.log(8.0), np.log(2000.0), (B, R)))
    side[:, :6] = [20.0, 70.0, 150.0, 300.0, 700.0, 2000.0]
    c = rng.uniform(-0.1, 1.1, (B, R, 2)) * size
    return np.concatenate([c - side[..., None] / 2, c + side[..., None] / 2],
                          -1).astype(np.float32)


def box_set(name, rng, B, R, size):
    return {"edge": edge_boxes, "elongated": elongated_boxes, "border": border_boxes,
            "subpixel": subpixel_boxes, "levels": level_boxes}[name](rng, B, R, size)
