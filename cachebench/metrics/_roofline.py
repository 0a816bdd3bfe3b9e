"""An attention kernel's share of its roofline over the profiled slice:
the roofline seconds of its launches in the slice's batches
(``counts.attention_bounds``) over its device seconds there."""
from cachebench import counts
from cachebench.metrics._common import deploy


def share(view, which: int, match):
    if view.slice is None or not view.slice_batches:
        return None
    mc, dep = deploy(view)
    bound = sum(counts.attention_bounds(mc, len(b.generated),
                                        dep["max_prompt_len"],
                                        dep["max_new_tokens"])[which]
                for b in view.slice_batches)
    spent = view.slice.time_of(match)
    if bound <= 0 or spent <= 0:
        return None
    return 100.0 * bound / spent
