"""The benchmark of the PyTorch and CUDA port, ``kube_batch_tpu_torch``:
its scheduling loop under open-loop gang storms on clusters at a
deployment's size. ``python3 -m benchmark.run --help``."""
