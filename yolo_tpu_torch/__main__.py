"""`python -m yolo_tpu_torch` == `python -m yolo_tpu_torch.cli`."""

from yolo_tpu_torch.cli import main

if __name__ == "__main__":
    main()
