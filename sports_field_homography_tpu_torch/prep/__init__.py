"""Offline dataset preparation: annotations to training sets (port of ``prep/``)."""
from .preparation import (
    FOOTBALL_PITCH_IGNORE_POINTS,
    MASK_CLASS_MAPPINGS,
    generate_requests,
    calculate_homography,
    find_homography_dlt,
    find_nonzero_points,
    calculate_reprojection_rmse,
    rescale_theta,
    generate_onehot,
    convert_rgb_to_onehot,
)
from .narya import (
    NARYA_TO_OUR_POI,
    convert_narya_keypoints,
    convert_narya_homography,
)
