"""The port's ops: the kernels' wrappers and their plain versions.

Importing the package registers the custom ops of the forward kernels
(library.py), through which the wrappers reach them."""

from dcl_net_tpu_torch.ops import library  # noqa: F401
