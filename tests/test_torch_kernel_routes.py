"""The Python side of the two kernels' wrappers, on CPU tensors: which route
and which access width each wrapper picks from dtype, shape, strides and
pointer alignment, how a route is forced, and the padding rules the CUDA
kernels rely on, checked in plain torch. The kernels themselves are held
against the plain versions on the card by ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from fewshot_vit_tpu_torch.kernels import attention as tk
from fewshot_vit_tpu_torch.kernels import sinkhorn as tks
from fewshot_vit_tpu_torch.ops.emd import normalize_weights

torch.set_num_threads(1)


def _packed_views(b, t, h, hd, dtype, offset=0):
    """q, k, v, out as the Visformer hands them over: heads split out of one
    packed (B, T, 3, H, hd) projection, read as (B, H, T, hd) views; the
    output a (B, T, H, hd) tensor written through such a view. ``offset``
    shifts every base pointer by that many elements."""
    n = b * t * 3 * h * hd
    qkv = torch.zeros(n + offset, dtype=dtype)[offset:].view(b, t, 3, h, hd)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    out = torch.zeros(b * t * h * hd + offset, dtype=dtype)[offset:].view(b, t, h, hd)
    return q, k, v, out.transpose(1, 2)


@pytest.mark.parametrize("t,hd,dtype,offset,route,vec", [
    (100, 42, torch.bfloat16, 0, "tensor_core", True),    # the main path: 84-byte rows
    (100, 42, torch.bfloat16, 1, "tensor_core", False),   # base pointers 2 bytes off
    (25, 85, torch.bfloat16, 0, "tensor_core", False),    # odd hd: rows 2-byte aligned
    (128, 128, torch.bfloat16, 0, "tensor_core", True),   # the route's limit
    (129, 64, torch.bfloat16, 0, "general", False),
    (512, 42, torch.bfloat16, 0, "general", False),
    (100, 42, torch.float32, 0, "general", False),        # fp32 never takes TF32 products
    (1, 1, torch.bfloat16, 0, "tensor_core", False),
])
def test_mhsa_route_and_alignment(t, hd, dtype, offset, route, vec):
    q, k, v, out = _packed_views(2, t, 6, hd, dtype, offset)
    assert q.stride() == (t * 3 * 6 * hd, hd, 3 * 6 * hd, 1)  # token stride 756 at hd 42
    assert tk.mhsa_route(q) == route
    assert tk._resolve_route(q, None) == route
    assert tk._resolve_route(q, "general") == "general"  # the general route takes everything
    if route == "tensor_core":
        assert tk.mhsa_vectorized(q, k, v, out) is vec
        with tk.force_route("general"):
            assert tk._resolve_route(q, None) == "general"
            assert tk._resolve_route(q, "tensor_core") == "tensor_core"  # the argument wins
        assert tk._resolve_route(q, None) == "tensor_core"  # the context restores
    else:
        with pytest.raises(ValueError, match="tensor-core route"):
            tk._resolve_route(q, "tensor_core")
    with pytest.raises(ValueError, match="route must be"):
        tk._resolve_route(q, "fastest")
    before = dict(tk.fused_mhsa.route_launches)
    tk.fused_mhsa(q, k, v, 1.0)  # CPU tensors: the plain version, no launch
    assert tk.fused_mhsa.route_launches == before


def test_mhsa_odd_stride_is_not_vectorized():
    """An odd token stride (heads of odd width packed side by side) breaks the
    4-byte alignment of every second row even when hd itself is even."""
    buf = torch.zeros(2, 10, 3, 43, dtype=torch.bfloat16)
    q, k, v = (buf[:, :, i, None, :42].transpose(1, 2) for i in range(3))
    out = torch.zeros(2, 1, 10, 42, dtype=torch.bfloat16)
    assert q.stride(2) % 2 == 1
    assert not tk.mhsa_vectorized(q, k, v, out)
    assert tk.mhsa_vectorized(out, out, out, out)


@pytest.mark.parametrize("n1,n2,route,lanes", [
    (13, 13, "packed", 16), (9, 13, "packed", 16), (16, 16, "packed", 16),
    (17, 9, "packed", 32), (25, 25, "packed", 32), (32, 32, "packed", 32),
    (33, 33, "general", None), (9, 33, "general", None), (64, 64, "general", None),
    (65, 9, None, None),
])
def test_sinkhorn_route_and_lanes(n1, n2, route, lanes):
    if route is None:
        with pytest.raises(ValueError, match="<= 64"):
            tks.sinkhorn_route(n1, n2)
        return
    assert tks.sinkhorn_route(n1, n2) == route
    assert tks._resolve_route(n1, n2, None) == route
    assert tks._resolve_route(n1, n2, "general") == "general"
    if route == "packed":
        assert tks.sinkhorn_lanes(n1, n2) == lanes
        with tks.force_route("general"):
            assert tks._resolve_route(n1, n2, None) == "general"
            assert tks._resolve_route(n1, n2, "packed") == "packed"
        assert tks._resolve_route(n1, n2, None) == "packed"
    else:
        with pytest.raises(ValueError, match="packed route"):
            tks.sinkhorn_lanes(n1, n2)
        with pytest.raises(ValueError, match="packed route"):
            tks._resolve_route(n1, n2, "packed")
    with pytest.raises(ValueError, match="route must be"):
        tks._resolve_route(n1, n2, "fastest")
    cost = torch.rand(3, n1, n2)
    w1, w2 = torch.full((3, n1), 1.0), torch.full((3, n2), n1 / n2)
    before = dict(tks.sinkhorn_pallas.route_launches)
    tks.sinkhorn_pallas(cost, w1, w2, iters=2)
    assert tks.sinkhorn_pallas.route_launches == before


@pytest.mark.parametrize("t,hd,t_pad,hd_pad", [(100, 42, 112, 48), (25, 85, 32, 96), (1, 1, 16, 16)])
def test_mhsa_padding_rule(t, hd, t_pad, hd_pad):
    """What the tensor-core kernel does in shared memory: head dims padded
    with zeros and keys padded to a multiple of 16 with score -inf leave the
    result unchanged. fp32, atol 0: a zero adds nothing to a dot product and
    exp(-inf) = 0 adds nothing to a softmax sum. The products are taken one
    output at a time (broadcast multiply, then a sum over the reduced axis in
    index order by cumsum), so that the padded and the plain computation add
    the same numbers in the same order."""
    rng = np.random.default_rng(t + hd)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, t, hd)).astype(np.float32))
               for _ in range(3))
    scale = hd ** -0.5

    def dot(a, b):  # (..., m, r) x (..., n, r) -> (..., m, n), summed in index order
        return (a[..., :, None, :] * b[..., None, :, :]).cumsum(-1)[..., -1]

    def attend(q, k, v, n_keys):
        s = dot(q, k) * scale
        s[..., n_keys:] = -float("inf")
        e = torch.exp(s - s.max(dim=-1, keepdim=True).values)
        p = e / e.cumsum(-1)[..., -1:]
        return dot(p, v.transpose(-1, -2))

    want = attend(q, k, v, t)
    pad = lambda x: torch.nn.functional.pad(x, (0, hd_pad - hd, 0, t_pad - t))  # noqa: E731
    got = attend(pad(q), pad(k), pad(v), t)[..., :t, :hd]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # and that order-controlled computation is the plain version's function
    torch.testing.assert_close(want, tk.fused_mhsa_reference(q, k, v, scale), rtol=1e-5, atol=1e-5)


def _padded_sinkhorn(cost, w1, w2, rows, cols, reg=0.05, iters=100):
    """The packed kernel's scheme in plain torch: log_k padded to (rows, cols)
    with -inf, padded rows' f and padded columns' g held at 0 (their own
    logsumexp is -inf - (-inf) = NaN and is dropped), natural logarithms.
    Sums run in index order (cumsum), so padding at the end only appends
    exact zeros to them."""
    b, n1, n2 = cost.shape
    log_k = torch.full((b, rows, cols), -float("inf"))
    log_k[:, :n1, :n2] = -cost / reg
    log_w1, log_w2 = torch.zeros(b, rows), torch.zeros(b, cols)
    log_w1[:, :n1], log_w2[:, :n2] = torch.log(w1), torch.log(w2)
    row_on = (torch.arange(rows) < n1)[None]
    col_on = (torch.arange(cols) < n2)[None]
    f, g = torch.zeros(b, rows), torch.zeros(b, cols)

    def lse(x):  # over the last axis
        m = x.max(dim=-1, keepdim=True).values
        return (m + torch.log(torch.exp(x - m).cumsum(-1)[..., -1:])).squeeze(-1)

    for _ in range(iters):
        f = torch.where(row_on, log_w1 - lse(log_k + g[:, None, :]), torch.zeros(()))
        g = torch.where(col_on, log_w2 - lse((log_k + f[:, :, None]).transpose(1, 2)),
                        torch.zeros(()))
    return torch.exp((log_k + f[:, :, None]) + g[:, None, :])


@pytest.mark.parametrize("n1,n2,iters", [(13, 13, 100), (9, 13, 100), (16, 16, 30), (17, 9, 100),
                                         (25, 25, 100), (32, 32, 30), (13, 13, 0), (25, 13, 1)])
def test_sinkhorn_padding_rule(n1, n2, iters):
    """Rows and columns padded with -inf log_k leave the flow unchanged: bit
    for bit against the same scheme without padding, and within 1e-5 of
    ``sinkhorn_reference`` (its sums group their terms otherwise; one ulp of a
    potential near 40 is 3.8e-6 of the flow). The padding itself stays 0."""
    rng = np.random.default_rng(n1 * 64 + n2)
    cost = torch.from_numpy(rng.uniform(0, 2, (4, n1, n2)).astype(np.float32))
    w1 = normalize_weights(torch.from_numpy(rng.uniform(-0.2, 1, (4, n1)).astype(np.float32)))
    w2 = normalize_weights(torch.from_numpy(rng.uniform(-0.2, 1, (4, n2)).astype(np.float32)))
    lanes = tks.sinkhorn_lanes(n1, n2)
    got = _padded_sinkhorn(cost, w1, w2, lanes, lanes, iters=iters)
    assert torch.isfinite(got).all()
    unpadded = _padded_sinkhorn(cost, w1, w2, n1, n2, iters=iters)
    torch.testing.assert_close(got[:, :n1, :n2], unpadded, rtol=0, atol=0)
    want = tks.sinkhorn_reference(cost, w1, w2, iters=iters)
    torch.testing.assert_close(got[:, :n1, :n2], want, rtol=0, atol=1e-5)
    assert got[:, n1:].abs().sum().item() == 0 and got[:, :, n2:].abs().sum().item() == 0
