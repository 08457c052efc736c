"""ZeRO over the data-parallel ranks — the sharding plan (``sharding``)
and the stage-3 chunked layer loop (``overlap``) — and ZeRO-Offload and
ZeRO-Infinity at one device: the host optimizer (``offload``), its
bucketed speculative form (``superoffload``), the NVMe optimizer tier
(``infinity``) and the layer-streamed parameter tier
(``param_stream``)."""
