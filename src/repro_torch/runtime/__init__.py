from repro_torch.runtime.supervisor import (Supervisor, StragglerMonitor,
                                            FailureInjector)
from repro_torch.runtime.faults import FaultSpec, FaultyTransport, backoff_delay
from repro_torch.runtime.delta_sync import (CorruptFrameError, DeltaFrame,
                                            DeltaPublisher, DeltaSubscriber,
                                            DirTransport, InProcTransport,
                                            PublishStats, SyncReport,
                                            Transport, apply_delta_flat,
                                            decode_frame, dense_sync_bytes,
                                            encode_frame, frame_epoch,
                                            frame_to_coo)

__all__ = [
    "Supervisor", "StragglerMonitor", "FailureInjector",
    "FaultSpec", "FaultyTransport", "backoff_delay",
    "CorruptFrameError", "DeltaFrame", "DeltaPublisher", "DeltaSubscriber",
    "DirTransport", "InProcTransport", "PublishStats", "SyncReport",
    "Transport", "apply_delta_flat", "decode_frame", "dense_sync_bytes",
    "encode_frame", "frame_epoch", "frame_to_coo",
]
