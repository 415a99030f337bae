"""neojax_torch.io — WAV file I/O, IR resampling, streaming-state checkpoints
and the native streaming runtime (``StreamExecutor``). ``neojax.io``'s
orbax pair waits for the distributed engines."""

from neojax_torch.io.checkpoint import load_state, save_state
from neojax_torch.io.executor import StreamExecutor
from neojax_torch.io.resample import polyphase_weights, resample
from neojax_torch.io.wav import read_wav, write_wav

__all__ = [
    "read_wav",
    "write_wav",
    "resample",
    "polyphase_weights",
    "StreamExecutor",
    "save_state",
    "load_state",
]
