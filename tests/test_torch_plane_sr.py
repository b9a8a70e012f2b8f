"""nvsr_tpu_torch.models.plane_sr (EDSR eval forward) against
nvsr_tpu.models.plane_sr at small widths (hidden 16, 2 blocks).

f32: atol 1e-5 (conv summation order). bf16: each conv output rounds to
bf16 on both sides, but accumulation order can flip a rounding and the
flip propagates through the residual trunk: atol 2e-3 (a few bf16 ULPs of
the unit-scale planes), mean below 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nvsr_tpu.models import plane_sr as jp
from nvsr_tpu_torch import bridge
from nvsr_tpu_torch.models import plane_sr as tp
from torch_port_helpers import t


def _port_cfg(jcfg):
    keep = {f.name for f in dataclasses.fields(tp.PlaneSRConfig)}
    return tp.PlaneSRConfig(**{k: v for k, v in
                               dataclasses.asdict(jcfg).items() if k in keep})


def _np_params(rng, jcfg):
    """EDSR params from a numpy seed (larger than the reference's
    Kaiming/10 init so the trunk is not a near-identity)."""
    tree = jax.tree.map(np.asarray, jp.init_plane_sr_params(
        jax.random.PRNGKey(0), jcfg))
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.3
                   / np.sqrt(np.prod(a.shape[1:]))).astype(np.float32),
        tree)


@pytest.mark.parametrize("bound", [None, 20])
def test_layer_plan_and_padding(bound):
    kw = {} if bound is None else {"receptive_field_bound": bound}
    for blocks, scale in ((2, 2), (4, 4), (32, 4)):
        jc = jp.PlaneSRConfig(n_blocks=blocks, scale_factor=scale, **kw)
        assert tp.edsr_layer_plan(blocks, scale, jc.receptive_field_bound) \
            == jp.edsr_layer_plan(blocks, scale, jc.receptive_field_bound)
        pc = _port_cfg(jc)
        assert (pc.required_padding, pc.hr_overpadding) == \
            (jc.required_padding, jc.hr_overpadding)


@pytest.mark.parametrize("scale,compute,norm", [
    (2, None, False), (4, None, True), (2, "bfloat16", False),
    (4, "bfloat16", True)])
def test_apply_plane_sr(rng, scale, compute, norm):
    jcfg = jp.PlaneSRConfig(in_channels=6, out_channels=6, hidden_size=16,
                            n_blocks=2, scale_factor=scale,
                            compute_dtype=compute, input_normalization=norm)
    params = _np_params(rng, jcfg)
    if norm:
        params["norm"] = {"mean": rng.standard_normal(6).astype(np.float32),
                          "std": rng.uniform(0.5, 2, 6).astype(np.float32)}
    lr = rng.standard_normal((3, 6, 12, 10)).astype(np.float32)
    ref = np.asarray(jp.apply_plane_sr(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(lr)))
    out = tp.apply_plane_sr(bridge.plane_sr_from_jax(params, "cpu"),
                            _port_cfg(jcfg), t(lr)).numpy()
    assert out.shape == ref.shape == (3, 6, 12 * scale, 10 * scale)
    err = np.abs(out - ref)
    if compute is None:
        assert err.max() < 1e-5, err.max()
    else:
        assert err.max() < 2e-3 and err.mean() < 1e-4, (err.max(),
                                                        err.mean())
