"""Draft proposal for n-gram speculative decoding.

The paged engine verifies K drafted tokens a decode row in one ragged
C=K+1 `paged_step` chunk (serving/graphs.py, the "spec" keys), so the
drafting here is host-side matching over token ids: no second model, no
extra dispatch, and nothing here touches a tensor (a host sync here would
serialize every decode step).

The proposer is prompt-lookup decoding: the most recent occurrence of
the current suffix n-gram in the request's own history (prompt +
generated tokens) predicts what comes next. Greedy verification keeps
the emitted stream the one speculation-off decoding gives: drafts only
decide how many tokens one dispatch confirms, never which.
"""

from __future__ import annotations

from repro_torch.core.policy import SpeculationConfig


class NgramProposer:
    """Suffix n-gram matcher over a request's own token history.

    `propose` tries the longest configured suffix first (`ngram_max` down
    to `ngram_min`): find the most recent EARLIER occurrence of the
    history's n-token suffix and return the up-to-`k` tokens that
    followed it; no match at any n returns []."""

    def __init__(self, cfg: SpeculationConfig | None = None):
        self.cfg = cfg or SpeculationConfig()

    def propose(self, history: list[int], k: int) -> list[int]:
        """Draft up to `k` tokens following `history` (prompt + output so
        far, most recent last); [] if no suffix n-gram recurs earlier.

        Selection: the most recent match of the LONGEST suffix n-gram
        whose continuation is a full k tokens; when every match of every
        n sits too close to the end for that (a short pure loop), the
        longest continuation seen, so a tight cycle still drafts the
        whole loop."""
        if k <= 0:
            return []
        cfg = self.cfg
        h = history
        n_hist = len(h)
        best: list[int] = []
        for n in range(min(cfg.ngram_max, n_hist - 1), cfg.ngram_min - 1, -1):
            suffix = h[n_hist - n:]
            # scan candidate match ends backward: most recent first
            for end in range(n_hist - 1, n - 1, -1):
                if h[end - n:end] == suffix:
                    cand = h[end:end + k]
                    if end + k <= n_hist:
                        return cand
                    if len(cand) > len(best):
                        best = cand
                    # earlier matches have longer continuations: keep
                    # scanning before settling for a truncated draft
        return best
