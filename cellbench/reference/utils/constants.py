# A frozen copy of the port's utils/constants.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Class tables and state-vector conventions (numpy copy of the parts of
``playground3d_tpu/utils/constants.py`` the port uses).

State vector convention (identical to the reference, kf.py:37-39 and
homography.py:274-320):

    state  = [x, y, l, w, h, v]            (filter-internal, 6)
    state7 = [x, y, l, w, h, dir, v]       (with direction, 7)

* ``x``   roadway-axis coordinate of the **rear center bottom** of the
          vehicle, in feet;
* ``y``   lane-transverse coordinate of the vehicle center, in feet;
* ``l/w/h`` length / width / height in feet;
* ``dir`` +1 if travelling in +x (EB), -1 otherwise (WB);
* ``v``   signed speed along the roadway axis, ft/s.

Space ("LMCS") boxes are [d, 8, 3] corner arrays ordered
fbr, fbl, bbr, bbl, ftr, ftl, btr, btl (front/back, top/bottom, right/left),
z negative upward for the top corners (reference homography.py:305-320).
Image boxes are [d, 8, 2] pixel arrays in the same corner order.
"""

from __future__ import annotations

import numpy as np

# int -> class name (reference homography.py:218-235)
CLASS_NAMES = (
    "sedan",
    "midsize",
    "van",
    "pickup",
    "semi",
    "truck (other)",
    "motorcycle",
    "trailer",
)

NUM_CLASSES = len(CLASS_NAMES)  # 8

# name -> int, including the "truck" alias (reference homography.py:218-226)
CLASS_IDS = {name: i for i, name in enumerate(CLASS_NAMES)}
CLASS_IDS["truck"] = CLASS_IDS["truck (other)"]

# Height prior per class, feet (reference homography.py:191-202).
_CLASS_HEIGHTS = {
    "sedan": 4.0,
    "midsize": 5.0,
    "van": 6.0,
    "pickup": 5.0,
    "semi": 12.0,
    "truck (other)": 12.0,
    "truck": 12.0,
    "motorcycle": 4.0,
    "trailer": 3.0,
    "other": 5.0,
}

# Height prior per class id, feet.
CLASS_HEIGHTS = np.array([_CLASS_HEIGHTS[name] for name in CLASS_NAMES], dtype=np.float32)

# [L, W, H] prior per class id, feet (reference homography.py:205-216).
CLASS_DIMS = np.array(
    [
        [16.0, 6.0, 4.0],
        [18.0, 6.5, 5.0],
        [20.0, 6.0, 6.5],
        [20.0, 6.0, 5.0],
        [55.0, 9.0, 12.0],
        [25.0, 9.0, 12.0],
        [7.0, 3.0, 4.0],
        [16.0, 7.0, 3.0],
    ],
    dtype=np.float32,
)

# The Homography_Wrapper dispatches between the EB-fit and WB-fit homography
# based on roadway-transverse coordinate y > 60 ft (reference
# homography.py:845,854,874,887).
EB_WB_Y_SPLIT_FT = 60.0

# ImageNet normalization used by the frame loaders (mp_loader.py:237-239).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

# Nominal camera frame period (reference kf.py:39).
DT_DEFAULT = 1.0 / 30.0

# Frame geometry used throughout the reference (1080p processing resolution).
FRAME_WIDTH = 1920
FRAME_HEIGHT = 1080


