"""The kernels' wrappers. Importing the package registers every kernel
entry point as a ``torch.library`` custom op of the ``bmhrl`` namespace,
which ``torch.export.load`` of an exported program needs first."""
from bmhrl_tpu_torch.ops import attention, critic_kernels  # noqa: F401
