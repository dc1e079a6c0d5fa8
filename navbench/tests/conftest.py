"""The benchmark's CPU tests run many small torch ops; one intra-op thread
per test process keeps parallel workers from starving each other."""

import os

import torch

os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)
