"""The hand-written CUDA kernels with their plain versions.  Importing the
package registers kernels 1 and 2 as ``torch.ops.gst.*`` (``ops.py``),
which their wrappers call."""

from . import ops  # noqa: F401
