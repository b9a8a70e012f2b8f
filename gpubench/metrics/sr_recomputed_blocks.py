"""sr_recomputed_blocks: the EDSR residual blocks that the backward of a
profiled HR iteration recomputed (the `plane_sr` spans' arg
`recomputed_blocks`, which the program counts in
models.plane_sr.BlockRecompute), over those spans: 3 planes x 32 blocks
where every block is recomputed, 0 where the trunk keeps its
activations. None where the program's `plane_sr` span has no such arg."""


def read(ctx):
    try:
        from nvsr_tpu_torch.utils import tracing
    except ImportError:
        return None
    counts = [r["args"]["recomputed_blocks"] for r in tracing.records()
              if r["name"] == "plane_sr" and "recomputed_blocks" in r["args"]]
    return sum(counts) / len(counts) if counts else None
