"""``python -m kube_batch_tpu_torch`` — the scheduler binary."""

from .cli import main

if __name__ == "__main__":
    main()
