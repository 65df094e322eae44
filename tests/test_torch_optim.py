"""Twins of tests/test_optim.py's clipping and schedule cases on the port
(repro_torch.optim, CPU tensors). The AdamW case's twin, against the JAX
package's update, is tests/test_torch_model.py's
test_adamw_update_matches_jax_fp32. The schedule also equals the JAX
package's at every step the case samples."""
import pytest

torch = pytest.importorskip("torch")

from repro.optim import warmup_cosine as jwarmup_cosine  # noqa: E402
from repro_torch.optim import (clip_by_global_norm, global_norm,  # noqa: E402
                               warmup_cosine)


def test_clip_by_global_norm():
    grads = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, norm = clip_by_global_norm(grads, 1.0)
    assert abs(float(norm) - 10.0) < 1e-5
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-5
    # below the threshold: untouched (the port scales in place)
    small = {"a": torch.full((4,), 1e-3)}
    before = small["a"].clone()
    out, _ = clip_by_global_norm(small, 1.0)
    assert torch.equal(out["a"], before)


def test_warmup_cosine_shape():
    steps = range(0, 101, 5)
    lrs = [float(warmup_cosine(torch.tensor(s), 1.0, 10, 100)) for s in steps]
    assert lrs[0] == 0.0
    assert abs(lrs[2] - 1.0) < 1e-6            # peak at end of warmup
    assert lrs[-1] <= lrs[2]
    assert abs(lrs[-1] - 0.1) < 1e-2           # floor
    assert all(a >= b - 1e-6 for a, b in zip(lrs[2:], lrs[3:]))  # monotone
    want = [float(jwarmup_cosine(s, 1.0, 10, 100)) for s in steps]
    assert max(abs(a - b) for a, b in zip(lrs, want)) < 1e-6
