"""AdaptedConv's regrouped prologue (``ops/conv_prologue.py``) on the CPU,
where it runs the kernels' plain versions, against the textbook formula
(reference models/KTGNN.py:275-284) in full-width torch ops:
outputs and the gradients of ``x`` and of every parameter, f32 and bf16
message tables, the benchmark's widths and an odd one, an empty domain,
the halo forms' split into the own rows' means and a given shift, and
``torch.utils.checkpoint``. No JAX here."""

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from bridged_gnn_tpu_torch.nn.common import masked_mean
from bridged_gnn_tpu_torch.nn.ktgnn import AdaptedConv


def textbook(conv, x, central, target):
    """The prologue as the reference writes it: the two masked means, the
    [x ‖ dd] gates, the shifted copies of x and the two linears."""
    mean_c = masked_mean(x, central, dim=0, keepdim=True)
    mean_t = masked_mean(x, target, dim=0, keepdim=True)
    dd = (mean_c - mean_t).expand_as(x)
    gcat = torch.cat([x, dd], dim=-1)
    shift_s2t = torch.tanh(conv.a_g_s2t(gcat)) * dd
    shift_t2s = torch.tanh(conv.a_g_t2s(gcat)) * dd
    u_s2t = conv.lin_t(x - shift_s2t * central[:, None].to(x.dtype))
    u_t2s = conv.lin_s(x + shift_t2s * target[:, None].to(x.dtype))
    if conv.msg_dtype is not None:
        u_s2t, u_t2s = u_s2t.to(conv.msg_dtype), u_t2s.to(conv.msg_dtype)
    return u_t2s, u_s2t


def regrouped(conv, x, central, target):
    return conv._branch(x, None, central, target)[:2]


def _case(d, h, n=97, seed=0, dtype=torch.float64, msg_dtype=None,
          empty=None):
    """A conv ``d → h`` and rows ``x`` [n, d] with a third of the rows
    padding (in neither domain); ``empty`` empties that domain."""
    g = torch.Generator().manual_seed(seed)
    conv = AdaptedConv(d, h, msg_dtype=msg_dtype, generator=g).to(dtype)
    x = torch.randn(n, d, generator=g, dtype=dtype) * 2 + 0.5
    node = torch.rand(n, generator=g) < 0.67
    cm = torch.rand(n, generator=g) < 0.5
    central, target = cm & node, ~cm & node
    if empty == "central":
        central = torch.zeros_like(central)
    elif empty == "target":
        target = torch.zeros_like(target)
    return conv, x, central, target


def _grads(fn, conv, x, central, target, seed=1):
    """Outputs and the gradients of x and every parameter of a weighted
    sum of both tables."""
    x = x.clone().requires_grad_()
    conv.zero_grad()
    u_t2s, u_s2t = fn(conv, x, central, target)
    g = torch.Generator().manual_seed(seed)
    w1 = torch.randn(u_t2s.shape, generator=g).to(u_t2s.dtype)
    w2 = torch.randn(u_s2t.shape, generator=g).to(u_s2t.dtype)
    ((u_t2s * w1).float().sum() + (u_s2t * w2).float().sum()).backward()
    grads = {n: p.grad.clone() for n, p in conv.named_parameters()
             if p.grad is not None}
    return u_t2s.detach(), u_s2t.detach(), x.grad, grads


WIDTHS = [(256, 64), (64, 31), (13, 7)]


@pytest.mark.parametrize("d,h", WIDTHS)
@pytest.mark.parametrize("empty", [None, "target", "central"])
def test_prologue_matches_textbook(d, h, empty):
    """In float64 the regrouping is the same function: outputs and every
    gradient agree to rounding."""
    conv, x, central, target = _case(d, h, empty=empty)
    got = _grads(regrouped, conv, x, central, target)
    want = _grads(textbook, conv, x, central, target)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
    assert got[3].keys() == want[3].keys() == {
        "a_g_s2t.weight", "a_g_t2s.weight", "lin_t.weight", "lin_t.bias",
        "lin_s.weight", "lin_s.bias"}
    for name in want[3]:
        torch.testing.assert_close(got[3][name], want[3][name], rtol=1e-10,
                                   atol=1e-10, msg=name)


@pytest.mark.parametrize("d,h", WIDTHS)
@pytest.mark.parametrize("msg_dtype", [None, "bfloat16"])
def test_prologue_matches_textbook_f32(d, h, msg_dtype):
    """float32 rows, f32 or bf16 message tables: the tables in the
    message dtype, within one rounding of it (bf16) or f32 rounding;
    the gradients within f32 rounding of sums over the rows."""
    conv, x, central, target = _case(d, h, dtype=torch.float32,
                                     msg_dtype=msg_dtype)
    got = _grads(regrouped, conv, x, central, target)
    want = _grads(textbook, conv, x, central, target)
    out_dtype = torch.bfloat16 if msg_dtype else torch.float32
    assert got[0].dtype == got[1].dtype == out_dtype
    tol = 2 ** -7 if msg_dtype else 1e-5
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-5)
    for name in want[3]:
        torch.testing.assert_close(got[3][name], want[3][name], rtol=1e-4,
                                   atol=1e-4, msg=name)


def test_prologue_under_checkpoint():
    """Recomputed in the backward (``remat``), the prologue gives the
    plain run's gradients bit for bit: it draws nothing and sums in a
    fixed order."""
    conv, x, central, target = _case(64, 31, dtype=torch.float32,
                                     msg_dtype="bfloat16")

    def under(conv, x, central, target):
        return checkpoint(regrouped, conv, x, central, target,
                          use_reentrant=False, preserve_rng_state=False)

    got = _grads(under, conv, x, central, target)
    want = _grads(regrouped, conv, x, central, target)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    for name in want[3]:
        assert torch.equal(got[3][name], want[3][name]), name


def test_prologue_given_shift_splits_the_rows():
    """The halo forms' two calls: the means over the first rows (their
    shift returned), and the other rows projected with that shift given.
    Together they are the whole rows' prologue with the means over the
    first rows, outputs and gradients, ``x``'s included through both
    calls' shift."""
    conv, x, central, target = _case(64, 31)
    own = 60

    def split(conv, x, central, target):
        u1, v1, dd = conv._branch(x[:own], None, central[:own],
                                  target[:own])
        u2, v2, _ = conv._branch(x[own:], dd, central[own:], target[own:])
        return torch.cat([u1, u2]), torch.cat([v1, v2])

    def whole(conv, x, central, target):
        return conv._branch(x, None, central, target, n_sum=own)[:2]

    got = _grads(split, conv, x, central, target)
    want = _grads(whole, conv, x, central, target)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
    for name in want[3]:
        torch.testing.assert_close(got[3][name], want[3][name], rtol=1e-10,
                                   atol=1e-10, msg=name)


def test_prologue_without_input_grad():
    """The first conv's input needs no gradient: the parameters' gradients
    are those of a run whose input needs one."""
    conv, x, central, target = _case(64, 31)
    u_t2s, u_s2t, _ = conv._branch(x, None, central, target)
    (u_t2s.sum() + 2 * u_s2t.sum()).backward()
    got = {n: p.grad.clone() for n, p in conv.named_parameters()
           if p.grad is not None}
    conv.zero_grad()
    u_t2s, u_s2t, _ = conv._branch(x.clone().requires_grad_(), None,
                                   central, target)
    (u_t2s.sum() + 2 * u_s2t.sum()).backward()
    for name, g in got.items():
        assert torch.equal(g, dict(conv.named_parameters())[name].grad)


@pytest.mark.parametrize("root_weight", [False, True])
def test_adapted_conv_state_dict_unchanged(root_weight):
    """The parameters keep their names and shapes (checkpoints, the flax
    import and the benchmark read them by name)."""
    conv = AdaptedConv(256, 31, root_weight=root_weight)
    want = {"a_f_t2s": [31], "a_f_s2t": [31],
            "a_g_s2t.weight": [1, 512], "a_g_t2s.weight": [1, 512],
            "lin_t.weight": [31, 256], "lin_t.bias": [31],
            "lin_s.weight": [31, 256], "lin_s.bias": [31]}
    if root_weight:
        want["lin_r.weight"] = [31, 256]
    assert {k: list(v.shape) for k, v in conv.state_dict().items()} == want
