from .operators import (LinearOp, DenseOp, BlockSparseOp, EllOp,
                        PermutedBlockSparseOp, conv_layout_perm, materialize)
from . import block_ell
