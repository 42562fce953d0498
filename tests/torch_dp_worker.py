"""One process of tests/test_torch_parallel.py's gloo test: joins the
group torchrun's variables describe (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT) through maybe_init_distributed, takes its half of case()'s
batch on a 2-entry CPU mesh, runs one DP train step and writes the loss
and the params to the .npz named by its argument. Imports no JAX."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from yolo_tpu_torch.configs import Conv, MaxPool, ModelConfig  # noqa: E402
from yolo_tpu_torch.data import targets as tgt  # noqa: E402
from yolo_tpu_torch.io import darknet_weights as dw  # noqa: E402
from yolo_tpu_torch.train import loop as tloop  # noqa: E402

ANCHORS3 = ((1.0, 1.5), (3.0, 3.0), (6.0, 4.0))
CFG = ModelConfig(
    name="micro",
    layers=(Conv(8), MaxPool(2, 2), Conv(16), MaxPool(2, 2), Conv(16),
            MaxPool(2, 2), Conv(16), MaxPool(2, 2), Conv(16), MaxPool(2, 2),
            Conv(3 * (5 + 4), size=1, bn=False, act="linear")),
    anchors=ANCHORS3, class_names=("a", "b", "c", "d"), input_size=64)


def case():
    """(config, params, the whole batch of 8, TrainConfig), seeded."""
    rng = np.random.default_rng(0)
    boxes, classes = [], []
    for _ in range(8):
        g = int(rng.integers(1, 4))
        boxes.append(np.stack([rng.uniform(0.2, 0.8, g),
                               rng.uniform(0.2, 0.8, g),
                               rng.uniform(0.05, 0.5, g),
                               rng.uniform(0.05, 0.5, g)], axis=-1))
        classes.append(rng.integers(0, 4, g))
    batch = tgt.encode_batch(boxes, classes, grid=(2, 2),
                             anchors=ANCHORS3, num_classes=4)
    batch["images"] = rng.uniform(0, 1, (8, 64, 64, 3)).astype(np.float32)
    params = dw.random_params(CFG.layers, np.random.default_rng(1))
    tcfg = tloop.TrainConfig(learning_rate=1e-3, weight_decay=0.0,
                             grad_accum=2)
    return CFG, params, batch, tcfg


def main(out_path: str) -> None:
    from yolo_tpu_torch.parallel import sharding as shd

    torch.set_num_threads(1)
    assert shd.maybe_init_distributed()
    rank = int(os.environ["RANK"])
    cfg, params, batch, tcfg = case()
    half = {k: v[rank * 4:(rank + 1) * 4] for k, v in batch.items()}
    mesh = shd.make_mesh(devices=["cpu", "cpu"])
    state = tloop.init_state(cfg, params, tcfg, device="cpu")
    m = shd.make_dp_train_step(cfg, tcfg, mesh)(state, half)
    out = {"loss": np.float32(m["loss"])}
    for i, p in enumerate(state.net.to_numpy()):
        out.update({f"{i}.{k}": v for k, v in p.items()})
    np.savez(out_path, **out)
    assert state.seen == 8
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
