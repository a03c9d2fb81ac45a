"""Visual debugging utilities: the port's copy of the JAX package's
``data/viz.py``.

Parity with the reference's ad-hoc debugging aids (SURVEY.md §4): trajectory
scatter plots (view_dataset_split_trajectory, i2i_util.py:429-435,
kitti_s2s.py:567-571) and registration overlap composites (the warpAffine
overlays of i2i_util.estimate_transform / loop_detector visualize branches).
File-output only (no imshow windows); matplotlib is optional.
"""

from __future__ import annotations

import numpy as np


def plot_split_trajectory(utm_db: np.ndarray, utm_q: np.ndarray,
                          out_path: str, title: str = "split") -> bool:
    """Scatter db vs query positions to a PNG. Returns False if matplotlib
    is unavailable (the capability degrades gracefully)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # pragma: no cover
        return False
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(utm_db[:, 0], utm_db[:, 1], s=4, label=f"db ({len(utm_db)})")
    ax.scatter(utm_q[:, 0], utm_q[:, 1], s=10, marker="x",
               label=f"queries ({len(utm_q)})")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return True


def match_overlay(
    query_image: np.ndarray, query_origin: np.ndarray,
    db_image: np.ndarray, db_origin: np.ndarray,
    xy_yaw: np.ndarray, resolution: float,
) -> np.ndarray:
    """Render the registered query over the db image → (S, S, 3) uint8.

    Red = db occupancy, green = transformed query occupancy (yellow where
    they agree) — the visual check the reference does with warpAffine
    overlays. The query's occupied pixels are mapped through (dx, dy, yaw):
    p_db = R(yaw)·p_q + t in metric coordinates, then rasterized into the db
    frame.
    """
    s = db_image.shape[0]
    out = np.full((s, s, 3), 255, np.uint8)
    occ_db = db_image < 0.5 if db_image.dtype != np.uint8 else db_image < 128
    out[occ_db] = (255, 80, 80)

    occ_q = query_image < 0.5 if query_image.dtype != np.uint8 else query_image < 128
    rr, cc = np.nonzero(occ_q)
    mx = query_origin[0] + cc * resolution
    my = query_origin[1] + rr * resolution
    c, sn = np.cos(xy_yaw[2]), np.sin(xy_yaw[2])
    tx = c * mx - sn * my + xy_yaw[0]
    ty = sn * mx + c * my + xy_yaw[1]
    col = np.round((tx - db_origin[0]) / resolution).astype(int)
    row = np.round((ty - db_origin[1]) / resolution).astype(int)
    ok = (col >= 0) & (col < s) & (row >= 0) & (row < s)
    on_db = occ_db[row[ok], col[ok]]
    # green where query lands on free db, yellow where both occupied
    out[row[ok][~on_db], col[ok][~on_db]] = (80, 200, 80)
    out[row[ok][on_db], col[ok][on_db]] = (230, 210, 60)
    return out


def save_png(path: str, rgb: np.ndarray) -> bool:
    """Write an (S, S, 3) uint8 image to ``path``. Returns False if no
    image backend is available (capability degrades gracefully, like
    plot_split_trajectory)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # pragma: no cover
        return False
    plt.imsave(path, rgb)
    return True
