"""``elementwise_ms``: device ms a step of the ``elementwise`` and
``copy/relayout`` kernels (``portbench/trace/chrome.py`` ``categorize``)."""


def read(view):
    ms = view.categories_ms({"elementwise", "copy/relayout"})
    return ms if ms > 0 else None
