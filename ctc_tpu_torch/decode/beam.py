"""CTC prefix beam search (port of ``ctc_tpu/decode/beam.py``): a plain
torch loop over T, batched over B.

Classic prefix beam search (Graves 2008, Hannun 2014) keeps, per prefix, the
log-probability of ending in blank (``p_b``) and in non-blank (``p_nb``).
Each step expands every beam by {blank, repeat-last, top-P new classes},
merges candidates with identical prefixes by log-sum-exp, and keeps the top
K.  Candidate order, the merge (all of a group's mass goes to its smallest
index) and the tie order of every top-k (lower index first) are the JAX
package's, so the two select the same beams.
"""

from __future__ import annotations

import torch

_NEG = -1.0e30


def _top_k(x: torch.Tensor, k: int):
    """``(values, indices)`` of the k largest along the last axis, ties to
    the lower index (``lax.top_k``'s order)."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return x.gather(-1, idx), idx


def _merge_duplicates(prefixes, lens, p_b, p_nb):
    """Log-sum-exp merge of candidates with identical prefixes.

    ``prefixes [B, N, M]``, the rest ``[B, N]``.  The representative of a
    group is its smallest candidate index; all group mass moves there and
    the others drop to the sentinel.
    """
    n = prefixes.shape[1]
    eq = (lens[:, :, None] == lens[:, None, :]) & (
        prefixes[:, :, None, :] == prefixes[:, None, :, :]).all(dim=-1)
    idx = torch.arange(n, device=prefixes.device)
    # rep[i] = smallest j with eq[i, j] (eq[i, i] is always true)
    rep = eq.to(torch.uint8).argmax(dim=2)
    is_rep = rep == idx
    member = rep[:, :, None] == idx[None, None, :]  # [B, i, j]

    def gather_merge(scores):
        contrib = torch.where(member, scores[:, :, None], _NEG)
        return torch.logsumexp(contrib, dim=1)

    return (torch.where(is_rep, gather_merge(p_b), _NEG),
            torch.where(is_rep, gather_merge(p_nb), _NEG))


def _step(state, lp_t, active, *, prune, blank, max_len):
    """One frame of the search for every sample; ``lp_t [B, C]``, samples
    past their input length (``active`` false) keep their state."""
    prefixes, lens, p_b, p_nb = state  # [B, K, M], [B, K], [B, K], [B, K]
    batch, k = lens.shape

    top_lp, top_cls = _top_k(lp_t, prune)  # [B, P]
    lp_blank = lp_t[:, blank]
    last = prefixes.gather(
        2, (lens - 1).clamp(0, max_len - 1)[..., None])[..., 0]  # [B, K]
    has_last = lens > 0
    p_any = torch.logaddexp(p_b, p_nb)

    # unchanged-prefix candidates (K)
    u_p_b = p_any + lp_blank[:, None]
    lp_last = torch.where(has_last, lp_t.gather(1, last.clamp(min=0)), _NEG)
    u_p_nb = torch.where(has_last, p_nb + lp_last, _NEG)

    # extension candidates (K x P)
    cls = top_cls[:, None, :].expand(batch, k, prune)
    clp = top_lp[:, None, :].expand(batch, k, prune)
    same_as_last = has_last[..., None] & (cls == last[..., None])
    base = torch.where(same_as_last, p_b[..., None], p_any[..., None])
    e_p_nb = clp + base
    beam_alive = p_any[..., None] > _NEG / 2
    valid_ext = (cls != blank) & (lens[..., None] < max_len) & beam_alive
    e_p_nb = torch.where(valid_ext, e_p_nb, _NEG)

    ext_prefixes = prefixes[:, :, None, :].expand(
        batch, k, prune, max_len).reshape(batch, k * prune, max_len).clone()
    ext_lens = lens[..., None].expand(batch, k, prune).reshape(batch, -1)
    ext_cls = cls.reshape(batch, -1)
    write_pos = ext_lens.clamp(0, max_len - 1)
    ext_prefixes.scatter_(2, write_pos[..., None], ext_cls[..., None])
    ext_ok = (ext_cls != blank) & (ext_lens < max_len)
    new_ext_lens = torch.where(ext_ok, ext_lens + 1, -7)  # invalid: len -7

    cand_prefixes = torch.cat([prefixes, ext_prefixes], dim=1)
    cand_lens = torch.cat([lens, new_ext_lens], dim=1)
    invalid = cand_lens == -7
    cand_p_b = torch.where(
        invalid, _NEG,
        torch.cat([u_p_b, torch.full_like(e_p_nb, _NEG).reshape(batch, -1)],
                  dim=1))
    cand_p_nb = torch.where(
        invalid, _NEG, torch.cat([u_p_nb, e_p_nb.reshape(batch, -1)], dim=1))

    m_p_b, m_p_nb = _merge_duplicates(cand_prefixes, cand_lens, cand_p_b,
                                      cand_p_nb)
    _, sel = _top_k(torch.logaddexp(m_p_b, m_p_nb), k)
    new_state = (
        cand_prefixes.gather(1, sel[..., None].expand(-1, -1, max_len)),
        cand_lens.gather(1, sel).clamp(min=0),
        m_p_b.gather(1, sel),
        m_p_nb.gather(1, sel),
    )
    # frozen once past this sample's input length
    return tuple(
        torch.where(active.view(-1, *([1] * (new.dim() - 1))), new, old)
        for new, old in zip(new_state, state)
    )


def beam_search_decode(logits, input_lengths, *, beam_width: int = 8,
                       prune: int = 8, blank: int = 0,
                       max_len: int | None = None):
    """Prefix beam search over ``[T, B, C]`` logits.

    Returns ``(prefixes [B, K, max_len] -1-padded, lengths [B, K],
    scores [B, K])``, beams sorted best-first.
    """
    max_t, batch, num_classes = logits.shape
    if max_len is None:
        max_len = max_t
    prune = min(prune, num_classes)
    log_probs = torch.log_softmax(logits, dim=2)
    dev = logits.device
    k = beam_width
    p_b = torch.full((batch, k), _NEG, dtype=log_probs.dtype, device=dev)
    p_b[:, 0] = 0.0
    state = (
        torch.zeros((batch, k, max_len), dtype=torch.long, device=dev),
        torch.zeros((batch, k), dtype=torch.long, device=dev),
        p_b,
        torch.full((batch, k), _NEG, dtype=log_probs.dtype, device=dev),
    )
    for t in range(max_t):
        state = _step(state, log_probs[t], t < input_lengths, prune=prune,
                      blank=blank, max_len=max_len)
    prefixes, lens, p_b, p_nb = state
    total = torch.logaddexp(p_b, p_nb)
    order = torch.sort(-total, dim=1, stable=True).indices
    prefixes = prefixes.gather(1, order[..., None].expand(-1, -1, max_len))
    lens = lens.gather(1, order)
    total = total.gather(1, order)
    mask = torch.arange(max_len, device=dev)[None, None, :] < lens[..., None]
    return torch.where(mask, prefixes, -1), lens, total
