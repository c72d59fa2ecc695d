"""One rank of the 4-process gloo runs of ``tests/test_torch_overlap.py``.

``python tests/test_torch_overlap_worker.py RANK WORLD INIT_FILE INPUTS OUT``
joins a gloo process group through ``file://INIT_FILE``, trains every
engine case of ``torch.load(INPUTS)`` with and without the overlap schedule
and saves the results to ``OUT``. It imports torch and the port only.
"""

import datetime
import logging
import os
import sys
import time

import torch
import torch.distributed as tdist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM  # noqa: E402
from deepspeed_tpu_torch.parallel import groups  # noqa: E402
from deepspeed_tpu_torch.runtime.zero.partition import is_resident  # noqa: E402
from test_torch_zero_worker import MaskedLM, local_rows  # noqa: E402


class Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def main():
    rank, world, init_file, inputs, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    caught = Warnings()
    logging.getLogger("deepspeed_tpu_torch").addHandler(caught)
    tdist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                             world_size=world, timeout=datetime.timedelta(seconds=120))
    inp = torch.load(inputs, weights_only=False)
    out, start = {}, time.perf_counter()
    for name, case in inp["cases"].items():
        t = time.perf_counter()
        caught.messages.clear()
        if case["model"] == "masked":
            model, params, batches = (MaskedLM(*inp["masked_dims"]), inp["masked_params"],
                                      inp["masked_batches"])
        else:
            model = LlamaForCausalLM(LlamaConfig(**inp["llama_dims"], dtype=torch.float32))
            params, batches = inp["llama_params"], inp["llama_batches"]
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=model, model_parameters=params, config=case["config"], device="cpu")
        losses, resident = [], []
        for b in batches:
            loss = engine(local_rows(b, rank, inp["micro"]))
            engine.backward(loss)
            # what backward left gathered: the stage-3 leaves still holding storage
            resident.append(sum(is_resident(leaf.param.data) for leaf in engine._leaves
                                if leaf.param_dim is not None))
            engine.step()
            losses.append(float(loss.detach()))
        out[name] = dict(losses=losses, resident_after_backward=resident,
                         prefetched_units=engine.prefetched_units,
                         prefetch_depth=engine._prefetch_depth,
                         buckets=None if engine._bucket_idxs is None
                         else engine._bucket_idxs,
                         units=len(engine._units),
                         warnings=list(caught.messages),
                         master=engine.get_model_parameters(),
                         seconds=time.perf_counter() - t)
        del engine
        groups.reset()
    out["seconds"] = time.perf_counter() - start
    print(f"rank {rank} seconds: " + ", ".join(
        f"{k} {v['seconds']:.1f}" for k, v in out.items() if isinstance(v, dict))
        + f", total {out['seconds']:.1f}", flush=True)
    torch.save(out, out_path)
    tdist.barrier()
    tdist.destroy_process_group()


if __name__ == "__main__":
    main()
