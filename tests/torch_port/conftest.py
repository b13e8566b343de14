"""The port's CPU tests run at tiny sizes, where torch's intra-op thread
pool buys nothing; one thread keeps them from contending for cores with the
suite's other test processes (some of which time their own steps)."""

import torch

torch.set_num_threads(1)
