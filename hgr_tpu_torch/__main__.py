"""``python -m hgr_tpu_torch --synthetic True --arch RN50 --train False``:
zero-shot evaluation on ``cuda:{--device}``."""

from .driver import main

if __name__ == "__main__":
    main()
