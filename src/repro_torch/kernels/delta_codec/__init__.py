"""Bitshuffle+RLE block codec for the delta_pack pipeline.

- ``host`` — pure-numpy encoder/decoder + frame assembly (no torch import);
             the format oracle, registered as chunkstore codec id 4.
- ``ops``  — the CUDA encode kernel's wrapper (``csrc/delta_codec.cu``),
             its plain torch version, and the sampled device-side probe.
"""
