from deepspeed_tpu_torch.inference.quantization.quantization import (  # noqa: F401
    QuantizedLinear, QuantizedParameter, dequantize_param_tree, quantize_param_tree,
    quantized_nbytes)
