"""The plane SR's convolution (`models.plane_sr.PlaneConv`) against
autograd's own `F.conv2d`: the forward bit-equal, the f32 and f64 data
gradient (a forward convolution of the output gradient with the weights
swapped and flipped) equal up to summation order, the weight gradient
and the bf16 data gradient the convolution's own (bit-equal), and
`PlaneConv.data_grads` counting the data gradients taken as forward
convolutions.

The CPU cases cover the plane SR's kernel sizes and paddings (1x1, VALID
and SAME 3x3, SRResNet's 9x9), non-square planes and channel pairs shaped
like the EDSR's (C -> hidden, hidden -> hidden, hidden -> 4 hidden,
hidden -> C) at small sizes, and a checkpointed residual block as
apply_edsr runs it. Tolerances, relative to the reference's largest
magnitude: 1e-12 in float64, 1e-5 in float32 (sums of k^2 * C_out
products in another order).

The test marked `cuda` (it skips without a device; the file needs no JAX:
`python -m pytest --noconftest -m cuda tests/test_torch_plane_sr_grad.py`)
runs the EDSR's two largest shapes of the stage-1 training cell in f32
with TF32 off, and checks that the backward launches no kernel of cuDNN's
FFT algorithm (its transforms `fft2d_*`, its complex GEMV `gemvx`)."""

import pytest
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from nvsr_tpu_torch.models.plane_sr import PlaneConv

C, HID = 6, 8
CHANNELS = ((C, HID), (HID, HID), (HID, 4 * HID), (HID, C))
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
DTYPES = (torch.float64, torch.float32, torch.bfloat16)

CASES = [("conv", k, p, cin, cout)
         for k in (1, 3, 9) for p in sorted({0, k // 2})
         for cin, cout in CHANNELS]
CASES += [("block", 3, 0, HID, HID), ("block", 1, 0, HID, HID)]


def _close(got, ref, dtype):
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= TOL[dtype] * scale


def _conv_ref(x, w, p):
    return F.conv2d(x, w, padding=p)


def _conv_new(x, w, p):
    return PlaneConv.apply(x, w, p)


def _block(conv, x, w1, w2, p):
    """An EDSR residual block (apply_edsr's, VALID when p == 0) under a
    non-reentrant checkpoint."""
    def body(h, w1, w2):
        m = w1.shape[-1] - 1 - 2 * p
        identity = h if m == 0 else h[:, :, m:-m, m:-m]
        return identity + 0.1 * conv(torch.relu(conv(h, w1, p)), w2, p)
    return checkpoint(body, x, w1, w2, use_reentrant=False)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plane_conv_matches_autograd(case):
    kind, k, p, cin, cout = case
    gen = torch.Generator().manual_seed(k * 100 + p * 10 + cout)
    for dtype in DTYPES:
        x = torch.randn((1, cin, 23, 17), generator=gen).to(dtype)
        w = torch.randn((cout, cin, k, k), generator=gen).to(dtype)
        w2 = torch.randn((cout, cout, k, k), generator=gen).to(dtype)
        if kind == "conv":
            def run(conv, x, w):
                return conv(x, w, p)
            n_convs = 1
        else:
            def run(conv, x, w):
                return _block(conv, x, w, w2, p)
            n_convs = 2
        as_forward = dtype in PlaneConv.FORWARD_DGRAD_DTYPES
        with torch.no_grad():
            assert torch.equal(run(_conv_new, x, w), run(_conv_ref, x, w))

        xs = [x.clone().requires_grad_() for _ in range(2)]
        ws = [w.clone().requires_grad_() for _ in range(2)]
        y_new, y_ref = run(_conv_new, xs[0], ws[0]), run(_conv_ref, xs[1],
                                                         ws[1])
        assert torch.equal(y_new, y_ref)
        dy = torch.randn(y_ref.shape, generator=gen).to(dtype)
        before = PlaneConv.data_grads
        dx, dw = torch.autograd.grad(y_new, (xs[0], ws[0]), dy)
        assert PlaneConv.data_grads - before == n_convs * as_forward
        dx_ref, dw_ref = torch.autograd.grad(y_ref, (xs[1], ws[1]), dy)
        if not as_forward:
            assert torch.equal(dx, dx_ref) and torch.equal(dw, dw_ref)
        else:
            _close(dx, dx_ref, dtype)
            if kind == "conv":
                assert torch.equal(dw, dw_ref)
            else:
                _close(dw, dw_ref, dtype)

        # the weight gradient alone takes no data gradient of the first
        # conv; a block's second conv still needs one to reach the first
        w_only = w.clone().requires_grad_()
        before = PlaneConv.data_grads
        (dw_only,) = torch.autograd.grad(run(_conv_new, x, w_only), w_only,
                                         dy)
        assert PlaneConv.data_grads - before == (n_convs - 1) * as_forward
        assert torch.equal(dw_only, dw)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the test is of cuDNN's algorithms)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cin, cout, size", [(256, 256, 330),
                                             (256, 1024, 404)])
def test_plane_conv_on_the_card(device, cin, cout, size):
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=device).manual_seed(size)
    x = torch.randn((1, cin, size, size), generator=gen, device=device)
    w = torch.randn((cout, cin, 3, 3), generator=gen, device=device) * 0.03
    xs = [x.clone().requires_grad_() for _ in range(2)]
    ws = [w.clone().requires_grad_() for _ in range(2)]
    y_new, y_ref = _conv_new(xs[0], ws[0], 0), _conv_ref(xs[1], ws[1], 0)
    assert torch.equal(y_new, y_ref)
    dy = torch.randn(y_ref.shape, generator=gen, device=device)
    before = PlaneConv.data_grads
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dx, dw = torch.autograd.grad(y_new, (xs[0], ws[0]), dy)
        torch.cuda.synchronize()
    assert PlaneConv.data_grads - before == 1
    dx_ref, dw_ref = torch.autograd.grad(y_ref, (xs[1], ws[1]), dy)
    _close(dx, dx_ref, torch.float32)
    _close(dw, dw_ref, torch.float32)
    kernels = {e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert kernels, "the profiler recorded no device kernel"
    assert not [n for n in kernels if "gemvx" in n or "fft2d" in n], kernels
