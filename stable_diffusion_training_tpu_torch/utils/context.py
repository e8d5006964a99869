"""Text-context window math of the train step.

Port of ``stable_diffusion_training_tpu/utils/context.py``: the BOS/EOS-strip
concat of the reference trainer. Window 0 keeps everything but its EOS,
middle windows drop both BOS and EOS, the last window keeps everything but
its BOS.
"""

import torch


def concat_context_windows(hidden: torch.Tensor, strip_bos_eos_token: bool) -> torch.Tensor:
    """``(B, concat, win, dim)`` per-window hidden states -> the ``(B, tokens,
    dim)`` cross-attention context. At ``concat == 1`` window 0 and window -1
    are the same window, so its tokens appear twice (2 * (win - 1)), as in
    the JAX package and the reference."""
    b, dim = hidden.shape[0], hidden.shape[-1]
    if not strip_bos_eos_token:
        return hidden.reshape(b, -1, dim)
    return torch.cat(
        [
            hidden[:, 0, :-1, :],
            hidden[:, 1:-1, 1:-1, :].reshape(b, -1, dim),
            hidden[:, -1, 1:, :],
        ],
        dim=1,
    )


def context_token_count(window: int, concat_count: int, strip_bos_eos_token: bool) -> int:
    """Token count ``concat_context_windows`` produces."""
    if not strip_bos_eos_token:
        return window * concat_count
    if concat_count == 1:
        return 2 * (window - 1)  # the degenerate duplicated-window case
    return (window - 2) * concat_count + 2
