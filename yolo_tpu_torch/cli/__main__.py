"""`python -m yolo_tpu_torch.cli` == `yolo-tpu-torch`."""

from yolo_tpu_torch.cli import main

if __name__ == "__main__":
    main()
