"""The benchmark's CPU tests run several harness runs side by side: each
takes two of the machine's threads, so that every timed window holds frames."""

import torch

torch.set_num_threads(2)
