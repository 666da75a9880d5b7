"""Worked example: frame points to the court and court points to the frame
through predicted thetas (port of ``utils/mapping_example.py``; writes
PNGs with cv2 instead of opening windows).

    python -m sports_field_homography_tpu_torch.utils.mapping_example

from the repository root (the default asset paths are relative to it).
"""
from __future__ import annotations

import numpy as np

from ..geometry.court import CourtSizes as CS
from ..geometry.court import (load_court_mask, load_court_poi, map_court_to_frame,
                              map_frame_to_court)

__all__ = ["map_frame_points_to_court", "map_court_poi_to_frame"]


def map_frame_points_to_court(out_path="frame_to_court.png",
                              template_path="./assets/template_ncaa_v4_s.png"):
    """A frame point mapped onto the court template, drawn there; returns
    the court points in pixels."""
    import cv2

    court_img = load_court_mask(template_path, court_size=CS.COURT_IN_PIXELS)
    theta_f2c = np.array([
        [8.030766487121582, -0.22687992453575134, 9.891857147216797],
        [3.553352117538452, 25.72734260559082, -0.09768841415643692],
        [0.1463453769683838, 5.179210662841797, 16.56546974182129],
    ])
    frame_points = np.array([[590, 418]], dtype=np.float32)
    court_points = map_frame_to_court(theta_f2c, frame_points, frame_size=CS.FRAME_IN_PIXELS)
    court_points[:, 0] *= CS.COURT_IN_PIXELS[0]
    court_points[:, 1] *= CS.COURT_IN_PIXELS[1]
    for pt in court_points:
        x, y = int(round(pt[0])), int(round(pt[1]))
        court_img = cv2.circle(court_img, (x, y), 5, color=(255, 0, 255), thickness=-1)
    cv2.imwrite(out_path, court_img)
    return court_points


def map_court_poi_to_frame(out_path="court_to_frame.png",
                           poi_path="./assets/template_ncaa_v4_points.json"):
    """The court's points of interest mapped into a blank frame, drawn
    there; returns the frame points in pixels."""
    import cv2

    court_poi = load_court_poi(poi_path)
    theta_f2c = np.array([
        [5.78266048, -0.43701401, 8.0031395],
        [3.63819695, 15.77359295, -0.46604609],
        [0.14406031, 3.68673325, 13.25017166],
    ])
    frame_poi = map_court_to_frame(np.linalg.inv(theta_f2c), court_poi)
    frame_poi[:, 0] *= CS.FRAME_IN_PIXELS[0]
    frame_poi[:, 1] *= CS.FRAME_IN_PIXELS[1]
    frame = np.zeros((CS.FRAME_IN_PIXELS[1], CS.FRAME_IN_PIXELS[0], 3), np.uint8)
    for pt in frame_poi:
        x, y = int(round(pt[0])), int(round(pt[1]))
        frame = cv2.circle(frame, (x, y), 5, color=(255, 0, 255), thickness=-1)
    cv2.imwrite(out_path, frame)
    return frame_poi


if __name__ == "__main__":
    map_frame_points_to_court()
    map_court_poi_to_frame()
