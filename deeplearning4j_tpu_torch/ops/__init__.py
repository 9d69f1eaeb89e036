"""Op set of the port. Importing the package registers every ported op
by name in the port's own registry (``ops.registry``), as the JAX
package's ``ops/__init__.py`` does; kernel libraries still load only
inside the functions that launch them."""

from deeplearning4j_tpu_torch.ops.registry import get_op, list_ops, register_op
from deeplearning4j_tpu_torch.ops import (  # noqa: F401 (register)
    transforms, nn, conv_bn_stats, residual_tail,
)
# the graph engine's math ops (reduce_sum with ``dimensions=``, cast, ...);
# nothing in that chain imports the ops package itself, only ops.registry
from deeplearning4j_tpu_torch.autodiff import ops_math as _ops_math  # noqa: F401,E402

__all__ = ["get_op", "list_ops", "register_op"]
