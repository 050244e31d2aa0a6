"""GroupNorm32's unfused norm (ops/groupnorm.py::group_norm) on the card:
K3 where autograd records nothing, raising where K3 cannot take the input,
the plain version where autograd records, one route in a checkpoint's first
pass and in its recomputation, and each plain call on the card counted in
the open span.

No CUDA here: the tensors claim to be on the card and K3's wrapper is
replaced by a recorder that computes the plain version, so what is checked
is the routing itself; the refusals run K3's own wrapper, which raises
before it reaches the card. chip_smoke.py holds K3 to the plain version on
the card.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.checkpoint import checkpoint

from test_torch_port_helpers import one_torch_thread

from reface_tpu_torch.core import profiling
from reface_tpu_torch.nn.layers import GroupNorm32
from reface_tpu_torch.ops import groupnorm as G

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

PLAIN = G.group_norm_silu_plain


def _on_card(monkeypatch):
    """Every tensor claims to be on the card; returns the routes taken, in
    order: ("k3", shape) or ("plain", shape)."""
    routes = []

    def k3(x, scale, bias, groups, eps, silu):
        assert x.is_contiguous() and not silu
        routes.append(("k3", tuple(x.shape)))
        return PLAIN(x, scale, bias, groups, eps, silu)

    def plain(x, scale, bias, groups, eps, silu):
        routes.append(("plain", tuple(x.shape)))
        return PLAIN(x, scale, bias, groups, eps, silu)

    monkeypatch.setattr(G, "group_norm_silu", k3)
    monkeypatch.setattr(G, "group_norm_silu_plain", plain)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    return routes


def _norm(channels=64, groups=32):
    gn = GroupNorm32(channels, num_groups=groups)
    with torch.no_grad():
        gn.weight.normal_()
        gn.bias.normal_()
    return gn


def test_k3_only_where_autograd_records_nothing(monkeypatch):
    """no_grad, inference_mode, or grad on with nothing requiring grad: K3.
    Grad on with x or a parameter requiring grad: the plain version, whose
    output carries the gradient. Every route returns the plain numbers."""
    routes = _on_card(monkeypatch)
    gn = _norm()
    x = torch.randn(2, 64, 4, 4) * 3 + 1
    ref = PLAIN(x, gn.weight, gn.bias, 32, 1e-5, False)
    outs = []
    with torch.no_grad():
        outs.append(gn(x))
    with torch.inference_mode():
        outs.append(gn(x))
    gn.requires_grad_(False)
    outs.append(gn(x))
    assert routes == [("k3", (2, 64, 4, 4))] * 3
    routes.clear()
    xg = x.clone().requires_grad_()
    outs.append(gn(xg))  # x requires grad
    gn.requires_grad_(True)
    outs.append(gn(x))  # a parameter requires grad
    assert routes == [("plain", (2, 64, 4, 4))] * 2
    assert outs[3].requires_grad and outs[4].requires_grad
    outs[3].sum().backward()
    outs[4].square().sum().backward()
    assert xg.grad.abs().sum() > 0 and gn.weight.grad.abs().sum() > 0
    for y in outs:
        torch.testing.assert_close(y.detach(), ref, atol=0, rtol=0)


def _misaligned(shape):
    """An fp32 tensor whose first element sits 4 bytes past a 16-byte boundary."""
    flat = torch.randn(1 + torch.Size(shape).numel())
    return flat[1:].view(shape)


@pytest.mark.parametrize("what,make,channels", [
    ("bf16", lambda: torch.randn(2, 64, 4, 4).bfloat16(), 64),
    ("channels-last", lambda: torch.randn(2, 64, 4, 4).to(memory_format=torch.channels_last),
     64),
])
def test_k3_takes_bf16_and_channels_last(monkeypatch, what, make, channels):
    """Under no_grad a bf16 input takes K3, and a channels-last one is made
    contiguous and takes K3. The output keeps the input's dtype."""
    routes = _on_card(monkeypatch)
    gn = _norm(channels)
    x = make()
    with torch.no_grad():
        y = gn(x)
    assert [r for r, _ in routes] == ["k3"], what
    assert y.dtype == x.dtype and y.shape == x.shape
    torch.testing.assert_close(y, PLAIN(x, gn.weight, gn.bias, 32, 1e-5, False), atol=0, rtol=0)


@pytest.mark.parametrize("what,make,channels,match", [
    ("fp16", lambda: torch.randn(2, 64, 4, 4).half(), 64, "float32/bfloat16"),
    ("C % groups", lambda: torch.randn(2, 48, 4, 4), 48, "C % groups"),
    ("H*W % 8", lambda: torch.randn(2, 64, 3, 3), 64, "H\\*W % 8"),
    ("unaligned", lambda: _misaligned((2, 64, 4, 4)), 64, "16-byte alignment"),
])
def test_k3_raises_where_it_cannot_take_the_input(monkeypatch, what, make, channels, match):
    """Under no_grad an input K3 refuses (dtype, C % groups, H*W % 8, a
    16-byte boundary) raises K3's ValueError, as the fused path does: no
    plain version is taken behind the caller's back."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.Tensor, "is_cpu", property(lambda self: False))
    plain = []
    monkeypatch.setattr(G, "group_norm_silu_plain", lambda *a: plain.append(a))
    gn = _norm(channels)
    x = make()
    with torch.no_grad(), pytest.raises(ValueError, match=match):
        gn(x)
    assert not plain, what


class _Block(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.norm = _norm()
        self.conv = torch.nn.Conv2d(64, 64, 1)

    def forward(self, x):
        return self.conv(torch.nn.functional.silu(self.norm(x)))


@pytest.mark.parametrize("x_grad,params_grad", [(True, True), (True, False), (False, True)])
def test_a_checkpoint_takes_one_route_in_both_passes(monkeypatch, x_grad, params_grad):
    """Under checkpoint(use_reentrant=False) with x or the parameters
    requiring grad, the first pass and the recomputation both take the plain
    version (K3 would save nothing, and the recomputation would not match);
    the gradients are those of the block without the checkpoint."""
    routes = _on_card(monkeypatch)
    block = _Block()
    block.requires_grad_(params_grad)
    x = torch.randn(2, 64, 4, 4).requires_grad_(x_grad)
    y = checkpoint(block, x, use_reentrant=False)
    y.square().sum().backward()
    assert routes == [("plain", (2, 64, 4, 4))] * 2
    leaves = [x] * x_grad + list(block.parameters()) * params_grad
    got = [t.grad.clone() for t in leaves]
    for t in leaves:
        t.grad = None
    block(x).square().sum().backward()
    for g, t in zip(got, leaves):
        torch.testing.assert_close(g, t.grad, atol=0, rtol=0)


def test_plain_calls_counted_on_the_card_only(monkeypatch):
    """On the card each plain call counts as `group_norm_plain` in the
    innermost open span (the K3 route counts through its wrapper's
    count_launch); on the CPU nothing is counted."""
    gn = _norm()
    x = torch.randn(2, 64, 4, 4)
    before = max((r.id for r in profiling.spans()), default=0)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("cpu"):
            gn(x)
            with torch.no_grad():
                gn(x)
        with monkeypatch.context() as m:
            routes = _on_card(m)
            with profiling.span("card"):
                gn(x)
                with profiling.span("card.inner"):
                    gn(x)
                    gn(x)
                with torch.no_grad():
                    gn(x)
    got = {r.name: r.counts for r in profiling.spans() if r.id > before}
    assert [r for r, _ in routes] == ["plain", "plain", "plain", "k3"]
    assert got == {"cpu": {}, "card": {"group_norm_plain": 1},
                   "card.inner": {"group_norm_plain": 2}}
