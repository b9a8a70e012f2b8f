"""nvsr_tpu_torch.models.nerf_mlp against nvsr_tpu.models.nerf_mlp: the
same JAX-initialized weights (carried by bridge.nerf_mlp_from_jax) and
the same numpy-seeded encoded inputs through both forwards, for the
viewdir head (layers_dir + fc_alpha / fc_rgb / fc_feat), the fc_out head,
the mip input dims and xyz_input_2_dir. Tolerance: f32 matmuls summed in
another order, atol 1e-5 against outputs below 1 (measured <= 7.5e-8).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nvsr_tpu.models import nerf_mlp as jm
from nvsr_tpu_torch import bridge
from nvsr_tpu_torch.models import nerf_mlp as tm

CONFIGS = {
    # the YAML's trunk at a narrow width: 8 layers, skip every 4
    "viewdirs": jm.NeRFMLPConfig(num_layers=8, hidden_size=32,
                                 skip_connect_every=4,
                                 num_encoding_fn_xyz=6,
                                 num_encoding_fn_dir=4),
    "fc_out": jm.NeRFMLPConfig(num_layers=5, hidden_size=16,
                               skip_connect_every=2, use_viewdirs=False),
    # the baseline's mip dims (IPE degrees 0..15, dir PE 4 + raw)
    "mip": jm.NeRFMLPConfig(num_layers=8, hidden_size=32,
                            skip_connect_every=4, input_dim_xyz=96,
                            input_dim_dir=27),
    "mip_no_viewdirs": jm.NeRFMLPConfig(num_layers=4, hidden_size=16,
                                        use_viewdirs=False,
                                        input_dim_xyz=96, input_dim_dir=27),
    "xyz_to_dir": jm.NeRFMLPConfig(num_layers=4, hidden_size=16,
                                   num_layers_dir=2, xyz_input_2_dir=True),
}


def _port_cfg(jcfg):
    return tm.NeRFMLPConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(rng, name):
    jcfg = CONFIGS[name]
    tcfg = _port_cfg(jcfg)
    assert (tcfg.dim_xyz, tcfg.dim_dir) == (jcfg.dim_xyz, jcfg.dim_dir)
    tree = jax.tree.map(np.asarray, jm.init_nerf_mlp_params(
        jax.random.PRNGKey(3), jcfg))
    x = rng.standard_normal((64, jcfg.dim_xyz + jcfg.dim_dir)).astype(
        np.float32)
    ref = np.asarray(jm.apply_nerf_mlp(tree, jcfg, x))
    out = tm.apply_nerf_mlp(bridge.nerf_mlp_from_jax(tree, device="cpu"),
                            tcfg, torch.tensor(x)).numpy()
    assert out.shape == ref.shape == (64, 4)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_has_the_jax_layout(name):
    """init_nerf_mlp_params builds JAX's tree: the same keys, lists and
    leaf shapes, each layer's w within torch Linear's bound; and the
    bridge carries it back to numpy leaves unchanged."""
    jcfg = CONFIGS[name]
    jtree = jm.init_nerf_mlp_params(jax.random.PRNGKey(0), jcfg)
    ttree = tm.init_nerf_mlp_params(torch.Generator().manual_seed(0),
                                    _port_cfg(jcfg), device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jtree)
    assert jax.tree.map(lambda a: tuple(a.shape), ttree,
                        is_leaf=torch.is_tensor) == shapes
    for layer in jax.tree.leaves(ttree, is_leaf=lambda d: "w" in d
                                 if isinstance(d, dict) else False):
        bound = 1.0 / np.sqrt(layer["w"].shape[0])
        assert float(layer["w"].abs().max()) <= bound
    back = bridge.nerf_mlp_to_jax(ttree)
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(ttree, is_leaf=torch.is_tensor)):
        np.testing.assert_array_equal(a, b.numpy())
