"""Aspect-ratio resolution bucketing.

The port's own copy of ``stable_diffusion_training_tpu/data/buckets.py``:
widths step by ``rounding`` from the lower bound up to the area square-root,
heights are area/width floored to ``rounding``, and the set is mirrored
(portrait+landscape) with the square bucket deduplicated. Every bucket is
one entry of the trainer's step table (``train.aot``), so this math must
agree exactly between the loader and the trainer.
"""

from typing import Iterable, List, Tuple

import numpy as np


def calculate_resolution_array(
    max_res_area: int = 512**2, bucket_lower_bound_res: int = 256, rounding: int = 64
) -> np.ndarray:
    """Return (N, 2) array of (width, height) bucket resolutions.

    All dims are multiples of ``rounding``; width*height <= max_res_area;
    min(dim) >= bucket_lower_bound_res rounded down to ``rounding``.
    """
    centroid = int(max_res_area ** (1 / 2))
    if centroid < rounding or bucket_lower_bound_res < rounding:
        # the grid is `rounding`-aligned; smaller areas degenerate to
        # zero-width buckets: fail loudly instead
        raise ValueError(
            f"max_res_area**0.5 ({centroid}) and bucket_lower_bound_res "
            f"({bucket_lower_bound_res}) must both be >= rounding ({rounding})"
        )

    widths = np.arange(
        bucket_lower_bound_res // rounding * rounding,
        centroid // rounding * rounding + rounding,
        rounding,
    )
    # y = area/x, floored to the rounding grid: maximal height under the area cap
    heights = ((max_res_area / widths) // rounding * rounding).astype(int)

    # mirror to portrait orientation; drop the square duplicate if present
    if widths[-1] == heights[-1]:
        mirrored_w = np.flip(widths[:-1])
        mirrored_h = np.flip(heights[:-1])
    else:
        mirrored_w = np.flip(widths)
        mirrored_h = np.flip(heights)

    all_w = np.concatenate([widths, mirrored_h])
    all_h = np.concatenate([heights, mirrored_w])
    return np.stack([all_w, all_h]).T


def all_bucket_resolutions(
    image_area_roots: Iterable[int],
    minimum_axis_lengths: Iterable[int],
    rounding: int = 64,
) -> np.ndarray:
    """Concatenate bucket sets across all (area_root, min_axis) tiers."""
    buckets: List[np.ndarray] = []
    for area_root, min_axis in zip(image_area_roots, minimum_axis_lengths):
        buckets.append(
            calculate_resolution_array(
                max_res_area=area_root**2,
                bucket_lower_bound_res=min_axis,
                rounding=rounding,
            )
        )
    return np.concatenate(buckets)


def assign_bucket(
    width: int, height: int, resolutions: np.ndarray
) -> Tuple[int, int]:
    """Pick the bucket whose aspect ratio is closest to the image's, breaking
    ties toward larger area (host-side helper for the data loader)."""
    ar = width / height
    bucket_ars = resolutions[:, 0] / resolutions[:, 1]
    cost = np.abs(np.log(bucket_ars) - np.log(ar))
    best = np.argmin(cost + 1e-12 * -(resolutions[:, 0] * resolutions[:, 1]))
    return int(resolutions[best, 0]), int(resolutions[best, 1])
