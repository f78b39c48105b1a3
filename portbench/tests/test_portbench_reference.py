"""CPU tests of the plain reference's box comparison: a box is held
against every rectangle within ``NEAR_MIN`` of the least area, so that a
round component's box passes at whichever angle of least area the
program's search lands on, and a grown box does not."""
from __future__ import annotations

import cv2
import numpy as np
import pytest

from portbench.reference.postprocess import ANGLES, NEAR_MIN, iou, postprocess


def _gap(prob, box):
    pp = postprocess(prob, 0.5, 8, 100.0, 0.95)
    j = int(np.nonzero(pp["valid"])[0][0])
    return 1.0 - max(iou(box, near) for near in pp["near"][j])


def _box_at(pts, theta):
    c, s = np.cos(theta), np.sin(theta)
    u, v = pts @ np.array([c, s]), pts @ np.array([-s, c])
    us = np.array([u.min(), u.max(), u.max(), u.min()])
    vs = np.array([v.min(), v.min(), v.max(), v.max()])
    x, y = us * c - vs * s, us * s + vs * c
    return np.array([x.min(), y.min(), x.max(), y.max()]), (np.ptp(u) * np.ptp(v))


def test_a_round_component_passes_at_another_angle_of_least_area():
    prob = np.zeros((128, 128), np.float32)
    cv2.circle(prob, (64, 64), 30, 1.0, -1)
    ys, xs = np.nonzero(cv2.morphologyEx((prob > 0.5).astype(np.uint8),
                                         cv2.MORPH_GRADIENT, np.ones((3, 3))) & (prob > 0.5))
    pts = np.stack([xs, ys], 1).astype(np.float64)
    (_, _), (w, h), deg = cv2.minAreaRect(pts.astype(np.float32))
    least = w * h
    exact, _ = _box_at(pts, np.deg2rad(deg))
    # another angle, far from cv2's, whose rectangle is as small to rounding
    far = [t for t in ANGLES if abs(np.rad2deg(t) - deg % 90) > 10
           and _box_at(pts, t)[1] <= least * (1 + NEAR_MIN / 4)]
    assert far
    other = max((_box_at(pts, t)[0] for t in far), key=lambda b: 1.0 - iou(b, exact))
    assert 1.0 - iou(other, exact) > 0.3  # the exact box alone would fail it
    assert _gap(prob, other) < 0.01


@pytest.mark.parametrize("px", [1.0, 2.0])
def test_a_grown_text_box_fails(px):
    prob = np.zeros((128, 256), np.float32)
    prob[50:70, 30:230] = 1.0
    pp = postprocess(prob, 0.5, 8, 100.0, 0.95)
    j = int(np.nonzero(pp["valid"])[0][0])
    exact = pp["boxes"][j]
    assert _gap(prob, exact) < 1e-9
    grown = exact + np.array([-px, -px, px, px])
    assert _gap(prob, grown) > 0.08 * px
