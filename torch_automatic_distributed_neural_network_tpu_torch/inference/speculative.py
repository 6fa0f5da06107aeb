"""Greedy speculative decoding: a small draft model proposes, the target
verifies in one chunked forward.

The port of the JAX package's ``inference/speculative.py``.  The draft
greedily proposes ``k`` tokens, the target runs ONE (k+1)-token cached
forward over ``[last, d_1..d_k]``, and the longest prefix on which the
target's own greedy choices agree is accepted, plus the target's next
token, so every round emits between 1 and k+1 tokens for one target
chunk.  The emitted sequence is plain greedy decoding of the target, for
any draft: a bad draft costs acceptance, never correctness ("exact" up
to the chunk's reassociation of reductions against single-token steps;
the CPU tests pin equality at fp32).

Both models run through ``decode.forward_cached``; rolling a cache back
after a partial accept is setting its ``length`` (keys past it are
masked out and overwritten by the next round).  The JAX
``lax.while_loop`` is a Python loop.  Greedy only, batch 1, no
``eos_id``, as in the JAX package.

``ngram_propose`` and ``accept_length`` are the host-side halves the
serving engine uses for draft-model-free speculation (prompt lookup).
"""

from __future__ import annotations

import torch

from .decode import KVCache, forward_cached, model_device


def ngram_propose(history, k: int, *, max_n: int = 3) -> list:
    """Prompt-lookup drafting: propose ``k`` tokens by matching the
    longest trailing n-gram (n = max_n..1) against its most recent
    earlier occurrence in ``history`` and replaying what followed.
    Falls back to repeating the last token, so the proposal is always
    exactly ``k`` long (the verify chunk has a fixed width)."""
    hist = [int(t) for t in history]
    if k < 1:
        return []
    if not hist:
        return [0] * k
    drafts: list = []
    for n in range(min(max_n, len(hist) - 1), 0, -1):
        tail = hist[-n:]
        # the most recent earlier occurrence wins
        for i in range(len(hist) - n - 1, -1, -1):
            if hist[i:i + n] == tail:
                drafts = hist[i + n:i + n + k]
                break
        if drafts:
            break
    while len(drafts) < k:
        drafts.append(drafts[-1] if drafts else hist[-1])
    return drafts[:k]


def accept_length(drafts, targets) -> int:
    """Longest accepted prefix under the greedy rule: ``drafts[i]`` is
    accepted while it equals the target's own greedy choice
    ``targets[i]`` at that position."""
    a = 0
    for d, t in zip(drafts, targets):
        if int(d) != int(t):
            break
        a += 1
    return a


@torch.no_grad()
def speculative_generate(model, draft_model, prompt, *,
                         max_new_tokens: int, k: int = 4,
                         cache_dtype=torch.bfloat16) -> torch.Tensor:
    """Greedy speculative generation; returns [1, P + max_new_tokens]
    int32, the target ``model``'s own greedy output, with
    ``draft_model`` (same vocabulary) proposing.  Both models must be on
    one device."""
    cfg, dcfg = model.cfg, draft_model.cfg
    if cfg.vocab_size != dcfg.vocab_size:
        raise ValueError(
            f"target and draft vocabularies differ "
            f"({cfg.vocab_size} vs {dcfg.vocab_size})")
    device = model_device(model)
    prompt = torch.as_tensor(prompt).to(device=device, dtype=torch.int64)
    B, P = prompt.shape
    if B != 1:
        raise NotImplementedError(
            "speculative decoding accepts batch 1 (accept counts are "
            "per-sequence); loop over rows")
    if max_new_tokens < 1:
        return prompt.to(torch.int32)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    # +k+1 slack: a round may overshoot max_new before the final slice
    max_len = P + max_new_tokens + k + 1
    for name, c in (("target", cfg), ("draft", dcfg)):
        if c.pos == "learned" and c.max_seq_len < max_len:
            raise ValueError(
                f"{name} max_seq_len={c.max_seq_len} < prompt + "
                f"max_new_tokens + k + 1 = {max_len}: speculative rounds "
                f"need k+1 positions of headroom past the last emitted "
                f"token")
    cache = KVCache.init(cfg, B, max_len, dtype=cache_dtype, device=device)
    dcache = KVCache.init(dcfg, B, max_len, dtype=cache_dtype, device=device)

    # both prefill the prompt; ``last`` is the one emitted token not yet
    # cached (the caches hold keys for tokens[0..length-1])
    logits, cache = forward_cached(model, prompt, cache)
    last = int(torch.argmax(logits, -1)[0])
    _, dcache = forward_cached(draft_model, prompt, dcache)
    out = [last]
    while len(out) < max_new_tokens:
        # 1) the draft proposes k tokens continuing from ``last``; k+1
        # steps, the last one's output unused: its input write puts d_k's
        # key in the draft cache, so a full accept leaves it complete
        drafts, tok = [], last
        for _ in range(k + 1):
            lg, dcache = forward_cached(
                draft_model, torch.tensor([[tok]], device=device), dcache)
            tok = int(torch.argmax(lg, -1)[0])
            drafts.append(tok)
        drafts = drafts[:k]
        # 2) the target verifies [last, d_1..d_k] in one chunk
        chunk = torch.tensor([[last] + drafts], device=device)
        lg, cache = forward_cached(model, chunk, cache, all_logits=True)
        t = torch.argmax(lg[0], -1).tolist()  # [k+1] greedy targets
        # 3) accept d_1..d_a, then the target's own t_a
        a = accept_length(drafts, t[:k])
        out.extend(drafts[:a] + [t[a]])
        last = t[a]
        n_keys = cache.length - (k + 1) + a + 1  # roll back stale keys
        cache = cache._replace(length=n_keys)
        dcache = dcache._replace(length=min(dcache.length, n_keys))
    new = torch.tensor([out[:max_new_tokens]], dtype=torch.int32,
                       device=device)
    return torch.cat([prompt.to(torch.int32), new], dim=1)
