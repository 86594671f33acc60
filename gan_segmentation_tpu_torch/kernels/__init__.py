"""The hand-written CUDA kernels with their plain versions.  Importing the
package registers kernels 1, 2 and 3 as ``torch.ops.gst.*`` (``ops.py``),
which their wrappers call."""

from . import ops  # noqa: F401
