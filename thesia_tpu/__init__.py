"""thesia_tpu — a multi-track audio spectrogram/waveform engine on JAX.

A ground-up JAX/XLA rebuild of the capabilities of Sytronik/thesia
(reference: a Tauri desktop app with a Rust DSP backend).  The compute core —
STFT, mel projection, dB scaling, loudness stats, limiting and u16 image
quantization — runs batched on the accelerator (an NVIDIA GPU); the runtime
around it (track/session state, tile encoding, service, decode) is host
Python + native C++.

Layout:
  common/    mel scale, frequency-scale mapping, window functions
  dsp/       framing, batched STFT, dB conversion, spectrogram analyzer
  dynamics/  loudness (EBU R128), RMS/peak stats, normalize, guard clipping,
             lookahead limiter (associative-scan formulation)
  render/    u16 quantization, Lanczos3 resize, colormap LUT, render tiles,
             LRU tile cache
  engine/    Track/TrackList/TrackManager + the command surface / service
  io/        audio decode (WAV native; other codecs via native ext)
  axis/      axis tick/label computation (time/freq/amp/dB)
  player/    playback state machine, resampling, channel mixing
  parallel/  device-mesh sharding of the batched pipeline
"""

__version__ = "0.1.0"
