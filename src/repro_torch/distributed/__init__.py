"""The multi-controller runtime and its collectives over
``torch.distributed`` (counterpart of ``repro.distributed``'s ``runtime``
and ``collectives``)."""
