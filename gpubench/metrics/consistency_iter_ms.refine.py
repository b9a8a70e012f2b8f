"""consistency_iter_ms.refine: the device-stream ms of the profiled
`train_iteration` spans (`nvsr_tpu_torch.utils.tracing`) whose `kind` is
consistency, over their count. None where the program recorded none."""


def read(ctx):
    try:
        from nvsr_tpu_torch.utils import tracing
    except ImportError:
        return None
    ms = [r["ms"] for r in tracing.records()
          if r["name"] == "train_iteration"
          and r["args"].get("kind") == "consistency"]
    return sum(ms) / len(ms) if ms else None
