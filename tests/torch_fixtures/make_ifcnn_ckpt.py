"""Writes tests/torch_fixtures/ifcnn_jax/: a JAX package checkpoint of
IFCNN after one train step, as the JAX train CLI writes one
(`epoch_last.ckpt`, flax msgpack of the TrainState, and its `.json`
metadata: model, model_cfg, epoch), without its data loading: the JAX
package's own Trainer (the reference recipe, one device), its init from
PRNGKey(0), one step on two pairs of 64x64 patches from numpy seed 0,
then its `save_checkpoint`. Run from the repository's root with JAX on
the CPU:

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_ifcnn_ckpt.py
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..", "..")))

from multi_modal_image_fusion_tpu.models import create_model  # noqa: E402
from multi_modal_image_fusion_tpu.parallel.mesh import make_mesh  # noqa
from multi_modal_image_fusion_tpu.train.checkpoint import \
    save_checkpoint  # noqa: E402
from multi_modal_image_fusion_tpu.train.schedules import \
    make_lr_schedule  # noqa: E402
from multi_modal_image_fusion_tpu.train.trainer import Trainer  # noqa

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ifcnn_jax",
                   "epoch_last.ckpt")


def main():
    jax.config.update("jax_platforms", "cpu")
    r = np.random.RandomState(0)
    batch = tuple(jnp.asarray(r.rand(2, 64, 64, 1).astype(np.float32))
                  for _ in range(2))
    trainer = Trainer(create_model("ifcnn"), make_lr_schedule(1e-4, 10, 12),
                      mesh=make_mesh(jax.devices()[:1]))
    state = trainer.init_state(jax.random.PRNGKey(0), batch)
    state, _, _ = trainer.train_step(state, batch)
    save_checkpoint(OUT, state, {"model": "ifcnn", "data": "patches",
                                 "model_cfg": {}, "epoch": 1})
    print(OUT, os.path.getsize(OUT))


if __name__ == "__main__":
    main()
