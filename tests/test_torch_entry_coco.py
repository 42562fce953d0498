"""detect_raw(entry="fused") of the port against the JAX package's on
YOLOv2-COCO at full width (80 classes, 5 anchors, all 31 layers; input
cut to 160), in fp32 and bf16. The JAX entry kernel runs in interpret
mode and compiles for about a minute and a half per dtype at this size,
so these two cases have a file of their own (tests/test_torch_entry.py
holds the rest of the route). Tolerances:
tests/torch_port.py::check_fused_entry_route."""

import pytest
import torch

from tests.torch_port import check_fused_entry_route

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_detect_raw_fused_entry_matches_jax_coco(tmp_path, dtype):
    check_fused_entry_route(tmp_path, "coco", 160, dtype, conf=0.5)
