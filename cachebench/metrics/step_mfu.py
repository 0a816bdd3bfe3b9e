"""step_mfu: the FLOPs that the window's served batches needed
(``counts.generate_flops``: one prefill, the routed experts only,
attention over the positions held) over the sum of their wall times at
the card's bf16 peak, in %; the miss path's whole step."""
from cachebench import counts
from cachebench.metrics._common import deploy


def read(view):
    mc, dep = deploy(view)
    flops = sum(counts.generate_flops(mc, len(b.generated),
                                      dep["max_prompt_len"],
                                      dep["max_new_tokens"])
                for b in view.batches)
    wall = sum(b.t1 - b.t0 for b in view.batches)
    if flops <= 0 or wall <= 0:
        return None
    return 100.0 * flops / (wall * counts.PEAK_BF16_FLOPS)
