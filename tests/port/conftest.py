"""The port's tests run their plain PyTorch field work on two CPU threads.

Its tensors are small (a test's circuits have 2^4 to 2^17 rows), so more
intra-op threads do not shorten an op, and under several test workers on
one host they only contend: the recursion circuit's CPU proof takes about
the same 22-23 s on one thread as on eight alone.
"""

import torch

torch.set_num_threads(2)
