"""The factories of the port's AMD model zoo (``models/amd.py``:
``AMD_MODELS``) at full width: built on the ``meta`` device, each has the
parameter count of the JAX package's factory under ``jax.eval_shape``
(AMD_S 330.0 M, AMD_L 1011.2 M, AMD_S with the ``dual`` DiT 519.0 M,
AMD_S_Rec and AMD_S_RecSplit 202.1 M, AMD_N and AMD_S_Camera with 16
camera tokens, as a 16-frame window needs), the same model class, and
AMD_S_Camera has the object stream off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hivae_tpu.models import amd as jamd
from hivae_tpu_torch.models import amd as tamd
from test_torch_models import KEY

FACTORY_KW = {
    "AMD_S": dict(use_filter=True, use_grey=True),
    "AMD_L": dict(use_filter=True, use_grey=True),
    "AMD_S_dual": dict(use_filter=True, use_grey=True,
                       diffusion_model_type="dual"),
    "AMD_S_Camera": dict(use_filter=True, use_grey=True,
                         diffusion_model_type="spatial",
                         camera_motion_token_num=16),
    "AMD_N": dict(use_filter=True, use_grey=True,
                  diffusion_model_type="spatial", camera_motion_token_num=16),
    "AMD_S_Rec": {},
    "AMD_S_RecSplit": {},
}


def _jax_count(factory, kw):
    model = jamd.AMD_MODELS[factory](**kw)
    v = jax.ShapeDtypeStruct((1, 16, 4, 32, 32), jnp.float32)

    def init(x):
        rngs = {"params": KEY, "noise": KEY, "noise_kl": KEY}
        if isinstance(model, jamd.AMDModelRec):
            return model.init(rngs, x, x)
        return model.init(rngs, x, x, x, x)
    shapes = jax.eval_shape(init, v)
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


@pytest.mark.parametrize("name", sorted(FACTORY_KW))
def test_factory_parameter_counts_match_jax(name):
    factory = name.split("_dual")[0]
    kw = FACTORY_KW[name]
    port = tamd.AMD_MODELS[factory](device="meta", **kw)
    got = sum(p.numel() for p in port.parameters())
    assert got == _jax_count(factory, kw)
    assert type(port).__name__ == type(jamd.AMD_MODELS[factory]()).__name__
    if factory == "AMD_S_Camera":
        assert not port.cfg.use_object and port.cfg.use_camera
    counted = {"AMD_S": 330.0e6, "AMD_L": 1011.2e6, "AMD_S_dual": 519.0e6,
               "AMD_S_Rec": 202.1e6,
               "AMD_S_RecSplit": 202.1e6}
    if name in counted:
        assert round(got / 1e5) == round(counted[name] / 1e5)
