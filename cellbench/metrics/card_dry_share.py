"""card_dry_share: the share of a card's steps that found the card's
queue already drained, in %, the largest over the cards: 100 x
`feed.dry` / `feed.issues`, the port's own counters keyed by the card
(`cloudsc_tpu_torch.kernels.cuda_cloudsc.Feed`, counted in
`runtime.tracing`). When a step begins on a card, the port queries the
event it recorded where it finished issuing that card's last step; a
completed event means the card ran out of work before the host gave it
more. Steps run under the profiler are not counted, nor the first step
on a card. A program without the counters reads nothing."""

LAYER = "mesh"
MOVES = "columns_per_s"


def read(run):
    try:
        from cloudsc_tpu_torch.runtime import tracing
    except ImportError:
        return None
    issues = tracing.keyed("feed.issues")
    dry = tracing.keyed("feed.dry")
    shares = [100.0 * dry.get(card, 0) / n for card, n in issues.items() if n]
    return max(shares) if shares else None
