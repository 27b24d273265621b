"""Op classification for automatic mixed precision: the three lists of the
JAX package's ``contrib/amp/lists/symbol.py``, entry for entry (ref:
python/mxnet/contrib/amp/lists/symbol.py FP16_FUNCS / FP32_FUNCS /
WIDEST_TYPE_CASTS).

The target low precision is bfloat16, which shares float32's exponent
range, so the float32 list holds the ops whose accumulation precision
matters (normalizations, softmax with its reduction, losses, the exp/log
family), not only the overflow-prone ones an fp16 list guards.
"""

# Matmul-bound ops: inputs cast to the target dtype, where the tensor cores
# run at twice their float32 (TF32) rate (ref list: FP16_FUNCS).
TARGET_DTYPE_OPS = [
    "FullyConnected", "Convolution", "Deconvolution", "RNN",
    "dot", "batch_dot", "linalg_gemm", "linalg_gemm2",
]

# Numerically sensitive ops: float32 inputs (ref list: FP32_FUNCS).
FP32_OPS = [
    "BatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm",
    "L2Normalization", "LRN", "softmax", "Softmax", "softmin",
    "SoftmaxActivation", "SoftmaxOutput", "softmax_cross_entropy",
    "smooth_l1", "MakeLoss", "exp", "expm1", "log", "log10", "log2",
    "log1p", "log_softmax", "norm", "mean", "sum", "prod", "cumsum",
    "erfinv", "gamma", "gammaln", "CTCLoss", "ctc_loss",
]

# Multi-input elementwise ops: every floating input cast to the widest
# floating dtype among them (ref list: WIDEST_TYPE_CASTS).
WIDEST_TYPE_CASTS = [
    "add", "subtract", "multiply", "divide", "broadcast_add",
    "broadcast_sub", "broadcast_mul", "broadcast_div", "maximum",
    "minimum", "broadcast_maximum", "broadcast_minimum", "hypot",
    "concat", "Concat", "stack", "where", "power", "broadcast_power",
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
]

# Every other op runs in whatever dtype its inputs already have
# (ref: FP16_FP32_FUNCS, the "either" set).
