"""Version information (a copy of the JAX package's ``version.py`` that
names torch and its CUDA build in place of JAX).

Mirrors reference pkg/version/version.go (:28-35 — vars injected via
ldflags, Makefile:7-10; printed for --version). Here the build metadata is
set at import time with optional environment overrides (the setuptools/
Makefile analog of ldflags injection).
"""

from __future__ import annotations

import os
import platform
import sys

RELEASE_VERSION = os.environ.get("TPU_BATCH_VERSION", "0.1.0")
GIT_SHA = os.environ.get("TPU_BATCH_GIT_SHA", "unknown")
BUILT = os.environ.get("TPU_BATCH_BUILT", "unknown")


def print_version_and_exit(apiserver_version: str = "") -> None:
    """reference version.go:38-47 PrintVersionAndExit"""
    print(version_string())
    raise SystemExit(0)


def version_string() -> str:
    lines = [
        f"tpu-batch version: {RELEASE_VERSION}",
        f"  git sha: {GIT_SHA}",
        f"  built:   {BUILT}",
        f"  python:  {sys.version.split()[0]} on {platform.platform()}",
    ]
    import torch

    lines.append(f"  torch:   {torch.__version__} "
                 f"(cuda {torch.version.cuda or 'none'})")
    return "\n".join(lines)
