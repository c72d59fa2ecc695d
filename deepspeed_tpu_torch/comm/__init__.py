from deepspeed_tpu_torch.comm.comm import *  # noqa: F401,F403
