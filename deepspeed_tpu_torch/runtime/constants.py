"""Config key names and defaults (port of ``deepspeed_tpu/runtime/constants.py``)."""

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False

DUMP_STATE = "dump_state"

OPTIMIZER = "optimizer"
SCHEDULER = "scheduler"
MAX_GRAD_NORM = "max_grad_norm"

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

PRESCALE_GRADIENTS = "prescale_gradients"
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"

FP16 = "fp16"
BF16 = "bf16"
ZERO_OPTIMIZATION = "zero_optimization"

SPARSE_GRADIENTS = "sparse_gradients"
PREFETCH_BATCHES = "prefetch_batches"
FUSED_STEP = "fused_step"

DATA_TYPES = "data_types"
GRAD_ACCUM_DTYPE = "grad_accum_dtype"

ACTIVATION_CHECKPOINTING = "activation_checkpointing"
PIPELINE = "pipeline"
TENSOR_PARALLEL = "tensor_parallel"
SEQUENCE_PARALLEL_SIZE = "sequence_parallel_size"
EXPERT_PARALLEL_SIZE = "expert_parallel_size"

COMMS_LOGGER = "comms_logger"
MONITOR_TENSORBOARD = "tensorboard"
MONITOR_CSV = "csv_monitor"
MONITOR_WANDB = "wandb"
FLOPS_PROFILER = "flops_profiler"
TELEMETRY = "telemetry"
OVERLAP = "overlap"
RESILIENCE = "resilience"
ELASTICITY = "elasticity"
AUTOTUNING = "autotuning"
CHECKPOINT = "checkpoint"
COMPILE = "compile"

ROUTE_TRAIN = "train"
ROUTE_EVAL = "eval"
ROUTE_PREDICT = "predict"
ROUTE_ENCODE = "encode"
