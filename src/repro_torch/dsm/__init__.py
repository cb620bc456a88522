"""The CXL0 runtime on the host: .cxl0 frames, the pool, the tiers, the
FliT committer (sync schedule), recovery and the ``open_cxl0`` API."""
