"""Command line of the port (yolo_tpu/cli's commands, flags and output
lines, on the card by default; ``--device cpu`` only when asked for):

  python -m yolo_tpu_torch.cli predict --model coco --weights y.weights --image dog.jpg
  python -m yolo_tpu_torch.cli detect  --model coco --weights y.weights --images dir/ --batch 32
  python -m yolo_tpu_torch.cli train   --model voc --voc-root VOC2007 --weights init.weights
  python -m yolo_tpu_torch.cli eval    --model voc --voc-root VOC2007 --split test --weights x
  python -m yolo_tpu_torch.cli export  --model voc --checkpoint ck/final --output out.weights
  python -m yolo_tpu_torch.cli classify --model darknet53 --weights d.weights --image cat.jpg
  python -m yolo_tpu_torch.cli predict --model coco --weights y.weights --image dog.jpg --precision int8

  python -m yolo_tpu_torch.cli serve   --model coco --weights y.weights --dp
  python -m yolo_tpu_torch.cli train   --model voc --voc-root VOC2007 --weights init.weights --loader grain --loader-workers 4

What is not ported raises naming its ROADMAP item: a webcam index for
detect --video under the native decoder (A12a), bench (A13).
"""

from yolo_tpu_torch.cli._main import main  # noqa: E402  (the public entry)
from yolo_tpu_torch.cli.detect_cmds import (cmd_classify,  # noqa: F401,E402
                                            cmd_detect, cmd_predict)
from yolo_tpu_torch.cli.eval_cmd import cmd_eval, cmd_recall  # noqa: F401,E402
from yolo_tpu_torch.cli.tools_cmds import (cmd_anchors,  # noqa: F401,E402
                                           cmd_bench, cmd_doctor,
                                           cmd_export, cmd_partial,
                                           cmd_serve, cmd_zoo)
from yolo_tpu_torch.cli.train_cmd import cmd_train  # noqa: F401,E402
