"""The client-batched ("vmapped") simulator: ``VmapFedAvgAPI`` and its
asynchronous driver ``VmapAsyncFedAvgAPI`` (``async_rounds``)."""
