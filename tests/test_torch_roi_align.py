"""The port's RoIAlign (``aicity_action_tpu_torch/ops/roi_align.py``)
against the JAX package's (``aicity_action_tpu/ops/roi_align.py``) on every
case of ``tests/test_roi_align.py``, and against that file's per-sample
numpy oracle (detectron2's CPU kernel) where the JAX op agrees with it.

Each case holds the forward within 1e-5 and the gradient into the map of a
weighted sum of the output against ``jax.grad`` within 1e-5 (f32). The last
case is a box larger than the map under the default sample cap: both
packages saturate at ``ceil(H / out)`` samples a bin, where detectron2
would take more (a recorded divergence, ROADMAP Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicity_action_tpu.ops.roi_align import roi_align as jax_roi_align
from aicity_action_tpu_torch.ops.roi_align import roi_align
from test_roi_align import _ramp, _roi_align_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _random_boxes(rs, B, N, lo, hi, extent, ceiling):
    x1 = rs.uniform(lo, hi, N)
    y1 = rs.uniform(lo, hi, N)
    return np.stack([
        rs.randint(0, B, N).astype(np.float64), x1, y1,
        np.minimum(x1 + rs.uniform(1, extent, N), ceiling),
        np.minimum(y1 + rs.uniform(1, extent, N), ceiling)], 1)


def _cases():
    """``(id, features [B, H, W, C], boxes [N, 5], out, scale, kwargs,
    oracle)``: the cases of test_roi_align.py; ``oracle`` False where the
    JAX op departs from detectron2's kernel by design."""
    ones = np.ones((1, 4, 4, 1))
    box44 = np.array([[0, 0, 0, 4, 4]], np.float64)
    rs = np.random.RandomState(0)
    rand_feats = rs.randn(2, 14, 14, 3)
    rand_boxes = _random_boxes(rs, 2, 12, 0, 40, 30, 56)
    out = [
        ("aligned_center", _ramp(8, 8)[None], box44, 2, 1.0,
         dict(sampling_ratio=1), True),
        ("legacy_offset", _ramp(8, 8)[None], box44, 2, 1.0,
         dict(sampling_ratio=1, aligned=False), True),
        ("adaptive_per_roi", _ramp(8, 8)[None],
         np.array([[0, 0, 0, 2, 6]], np.float64), 2, 1.0, {}, True),
        ("spatial_scale", _ramp(4, 4, sy=0.0, sx=1.0)[None],
         np.array([[0, 0, 0, 16, 16]], np.float64), 2, 0.25,
         dict(sampling_ratio=2), True),
        ("zero_rule", ones, np.array([[0, 1, -4, 2, 0]], np.float64), 1,
         1.0, dict(sampling_ratio=4), True),
        ("degenerate_box", ones, np.array([[0, 2, 2, 2, 2]], np.float64),
         2, 1.0, {}, True),
    ]
    for aligned in (True, False):
        for sr in (0, 2):
            out.append((f"random_aligned{int(aligned)}_sr{sr}", rand_feats,
                        rand_boxes, 7, 0.25,
                        dict(sampling_ratio=sr, aligned=aligned), True))
    out.append(("boundary", np.random.RandomState(1).randn(1, 6, 6, 2),
                np.array([[0, -3.0, -3.0, 2.0, 2.0], [0, 4.0, 4.0, 9.0, 9.0],
                          [0, 0.0, 0.0, 6.0, 6.0],
                          [0, 2.25, 2.25, 2.75, 2.75]], np.float64),
                3, 1.0, {}, True))
    out.append(("cap_sufficient", np.random.RandomState(2).randn(1, 8, 8, 1),
                np.array([[0, 0, 0, 30, 30]], np.float64), 2, 1.0,
                dict(max_samples=16), True))
    out.append(("cap_saturates", np.random.RandomState(2).randn(1, 8, 8, 1),
                np.array([[0, 0, 0, 30, 30]], np.float64), 2, 1.0, {},
                False))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_and_gradient_match_jax(case):
    _, feats, boxes, out, scale, kw, oracle = case
    f32, b32 = feats.astype(np.float32), boxes.astype(np.float32)
    n, c = boxes.shape[0], feats.shape[-1]
    w = np.random.default_rng(3).standard_normal((n, out, out, c)).astype(
        np.float32)

    def weighted(f):
        y = jax_roi_align(f, b32, output_size=out, spatial_scale=scale, **kw)
        return (y * w).sum(), y

    # one compiled program (eager JAX runs the op's vmap op by op, ~3 s a
    # case), except where samples sit exactly on the map's far edge (y = H,
    # still valid): the compiled CPU program's fused multiply-adds move one
    # of them past it, so that case runs eagerly, as test_roi_align.py does
    fn = jax.value_and_grad(weighted, has_aux=True)
    if case[0] != "cap_sufficient":
        fn = jax.jit(fn)
    (_, want), g_want = fn(jnp.asarray(f32))
    want = np.asarray(want)
    ft = torch.from_numpy(f32).requires_grad_()
    got = roi_align(ft, torch.from_numpy(b32), output_size=out,
                    spatial_scale=scale, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    ref = _roi_align_np(feats, boxes, out, scale,
                        kw.get("sampling_ratio", 0), kw.get("aligned", True))
    if oracle:
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                                   atol=1e-5)
    else:  # the static cap: fewer samples than detectron2 takes
        assert np.abs(got.detach().numpy() - ref).max() > 1e-3

    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(g_want),
                               rtol=1e-5, atol=1e-5)


def test_bf16_map_gives_f32_bins():
    """A bf16 map is read in f32, as the JAX op promotes it through its f32
    coordinates."""
    rs = np.random.RandomState(4)
    feats = rs.randn(1, 6, 6, 4).astype(np.float32)
    boxes = np.array([[0, 0.5, 0.5, 5.0, 4.0]], np.float32)
    fb = torch.from_numpy(feats).bfloat16()
    got = roi_align(fb, torch.from_numpy(boxes), output_size=3,
                    spatial_scale=1.0)
    want = jax.jit(lambda f: jax_roi_align(
        f, boxes, output_size=3, spatial_scale=1.0))(
            jnp.asarray(feats, jnp.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
