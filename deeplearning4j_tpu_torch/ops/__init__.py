"""Op set of the port. Importing the package registers every ported op
by name in the port's own registry (``ops.registry``), as the JAX
package's ``ops/__init__.py`` does; kernel libraries still load only
inside the functions that launch them."""

from deeplearning4j_tpu_torch.ops.registry import get_op, list_ops, register_op
from deeplearning4j_tpu_torch.ops import (  # noqa: F401 (register)
    transforms, nn, random, reduce, shape, extra_indexing, flash_attention,
    conv_bn_stats, residual_tail, fused_update, paged_attention,
    tf_compat, tensor_array, bitwise, extra_math, linalg, declarable_tail,
    onnx_compat, image, compression,
)
# the graph engine's math ops (reduce_sum with ``dimensions=``, cast, ...)
# and control flow; nothing in that chain imports the ops package itself
from deeplearning4j_tpu_torch.autodiff import ops_math as _ops_math  # noqa: F401,E402
from deeplearning4j_tpu_torch.autodiff import control_flow as _control_flow  # noqa: F401,E402

__all__ = ["get_op", "list_ops", "register_op"]
