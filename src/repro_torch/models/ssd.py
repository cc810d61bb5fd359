"""Mamba2 / SSD (state-space duality) layer, arXiv:2405.21060 (the
reference's ``repro/models/ssd.py``).

The chunked algorithm: split the sequence into chunks of Q; compute the
intra-chunk term (quadratic in Q, matmuls) and carry the (H, P, N) state
across chunks. The reference carries it with a log-depth associative scan;
here it is a loop over the S / Q chunks (the same recurrence, summed in
another order, so held to the reference within a float32 tolerance).
Everything runs in float32, as the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.models.sharding import cumsum


def segsum(x):
    """Stable 'segment sum' producing the (..., Q, Q) decay matrix exponent:
    out[i, j] = sum_{k in (j, i]} x[k] for j <= i else -inf."""
    Q = x.shape[-1]
    cs = cumsum(x, -1)
    diff = cs[..., :, None] - cs[..., None, :]  # (..., i, j)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, float("-inf"))


def ssd_scan_ref(x, dt, A, B, C, chunk: int, initial_state=None):
    """x: (b, S, H, P); dt: (b, S, H) post-softplus; A: (H,) negative;
    B, C: (b, S, G, N). Returns (y (b,S,H,P), final_state (b,H,P,N))."""
    b, S, H, P = x.shape
    G, N = B.shape[-2], B.shape[-1]
    if S % chunk:
        # Pad to a chunk multiple with dt=0 entries: decay exp(0)=1 and
        # input contribution dt*x=0, so the final state is unaffected and
        # the padded y rows are sliced off below.
        pad = chunk - S % chunk
        padf = lambda a: torch.cat([a, torch.zeros_like(a[:, :1]).expand(
            -1, pad, *a.shape[2:])], dim=1)
        y, state = ssd_scan_ref(padf(x), padf(dt), A, padf(B), padf(C), chunk,
                                initial_state)
        return y[:, :S], state
    nc = S // chunk
    rep = H // G

    xc = x.reshape(b, nc, chunk, H, P)
    dtc = dt.reshape(b, nc, chunk, H)
    # each group's B and C for its rep heads (head h = g * rep + r), as a
    # broadcast: the backward sums the copies in one reduction, no atomics
    heads = lambda a: a.reshape(b, nc, chunk, G, 1, N).expand(
        b, nc, chunk, G, rep, N).reshape(b, nc, chunk, H, N)
    Bc, Cc = heads(B), heads(C)  # (b, c, q, H, N)

    dA = dtc * A  # (b, c, q, H)
    dAc = cumsum(dA, 2)

    # Intra-chunk: Y_intra[i] = sum_{j<=i} C_i B_j^T exp(sum_{(j,i]} dA) dt_j x_j
    L = torch.exp(segsum(dA.permute(0, 1, 3, 2)))  # (b, c, H, q, q)
    CB = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc)  # (b, c, H, q, k)
    scores = CB * L  # masked by L's -inf -> 0
    y_intra = torch.einsum("bchqk,bckh,bckhp->bcqhp", scores, dtc, xc)

    # Chunk states: S_c = sum_j exp(sum_{(j, end]} dA) B_j dt_j x_j
    decay_to_end = torch.exp(dAc[:, :, -1:, :] - dAc)  # (b, c, q, H)
    S_c = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", Bc, dtc * decay_to_end, xc)

    # Inter-chunk recurrence: h_c = h_{c-1} * exp(sum dA_c) + S_c, with the
    # running product of the decays for the initial state's share.
    chunk_decay = torch.exp(dAc[:, :, -1, :])  # (b, c, H)
    a_run = torch.ones_like(chunk_decay[:, 0])
    h_run = torch.zeros_like(S_c[:, 0])
    a_scan, h_scan = [], []
    for c in range(nc):
        a_run = a_run * chunk_decay[:, c]
        h_run = h_run * chunk_decay[:, c][..., None, None] + S_c[:, c]
        a_scan.append(a_run)
        h_scan.append(h_run)
    a_scan, h_scan = torch.stack(a_scan, 1), torch.stack(h_scan, 1)
    if initial_state is not None:
        h_scan = h_scan + a_scan[..., None, None] * initial_state[:, None]
    # States entering each chunk (shifted by one).
    h0 = (initial_state[:, None] if initial_state is not None
          else torch.zeros_like(h_scan[:, :1]))
    h_prev = torch.cat([h0, h_scan[:, :-1]], dim=1)
    y_inter = torch.einsum("bcqhn,bcqh,bchpn->bcqhp", Cc, torch.exp(dAc), h_prev)
    y = (y_intra + y_inter).reshape(b, S, H, P)
    return y, h_scan[:, -1]


def ssd_decode_step(x, dt, A, B, C, state):
    """One-token recurrence. x: (b, H, P); dt: (b, H); B, C: (b, G, N);
    state: (b, H, P, N). Returns (y (b,H,P), new state)."""
    G = B.shape[-2]
    H = x.shape[1]
    rep = H // G
    Br = B.repeat_interleave(rep, dim=1)  # (b, H, N)
    Cr = C.repeat_interleave(rep, dim=1)
    da = torch.exp(dt * A)  # (b, H)
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt, x, Br)
    new_state = state * da[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Cr)
    return y, new_state


def causal_conv1d(x, w, b=None):
    """Depthwise causal conv. x: (B, S, Cdim); w: (k, Cdim). The k - 1
    leading zeros are concatenated (DTensor's strategy for a pad fails)."""
    k = w.shape[0]
    pad = torch.cat([torch.zeros_like(x[:, :1]).expand(-1, k - 1, -1), x], dim=1)
    out = pad[:, 0:x.shape[1], :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + pad[:, i:i + x.shape[1], :] * w[i][None, None, :]
    return out if b is None else out + b


def conv_decode_step(x_new, conv_state, w, b=None):
    """x_new: (B, Cdim); conv_state: (B, k-1, Cdim). Returns (y, new_state)."""
    window = torch.cat([conv_state, x_new[:, None, :]], dim=1)  # (B, k, C)
    dt = torch.promote_types(window.dtype, w.dtype)  # as jnp.einsum promotes
    y = torch.einsum("bkc,kc->bc", window.to(dt), w.to(dt))
    if b is not None:
        y = y + b
    return y, window[:, 1:, :]
