"""``odin_tpu_torch.mpi`` is ``odin_tpu_torch.utils.mpi``, one module object
under both names (the JAX package keeps it as ``odin_tpu.utils.mpi``)."""
import sys

from odin_tpu_torch.utils import mpi as _mpi

sys.modules[__name__] = _mpi
