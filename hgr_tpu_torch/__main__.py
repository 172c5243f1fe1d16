"""``python -m hgr_tpu_torch --synthetic True --arch RN50 --n_episodes 4 --epochs 1``:
OM fine-tuning on ``cuda:{--device}``; with ``--train False``, zero-shot
evaluation."""

from .driver import main

if __name__ == "__main__":
    main()
