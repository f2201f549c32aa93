"""sca-ldpc-tpu: a JAX framework for code-based key-recovery side-channel
attack simulation on post-quantum KEMs (HQC, Kyber), run on NVIDIA GPUs.

Re-designed from scratch for accelerators (JAX / XLA / sharded jit) with the
capabilities of the reference CPU/Rust implementation (atneit/SCA-LDPC):

- ``codes``:    LDPC / QC-LDPC parity-check construction with distance-spectrum
                constraints (reference: simulate/make_code.py, distance_spectrum.py)
- ``channels``: measurement-channel / oracle-noise models
                (reference: simulate/decode.py ErrorsProvider)
- ``ops``:      batched binary & q-ary belief-propagation / min-sum decoders as
                vectorized JAX compiled by XLA (reference: ldpc PyPI
                bp_decoder, simulate_rs/src/decoder.rs, decoder_special.rs)
- ``sim``:      frame-error-rate Monte-Carlo loops, jitted and batched
                (reference: simulate/decode.py simulate_frame_error_rate*)
- ``models``:   HQC key-recovery attack pipeline + native HQC model
                (reference: simulate/hqc.py, simulate_rs/src/hqc.rs) and the
                Kyber-768 pipeline (simulate/kyber.py, max_likelihood.py)
- ``parallel``: device-mesh sharding of frame/trace batches, psum/all_gather
                aggregation of FER and key-recovery statistics
- ``viz``:      plotting / CSV analysis (reference: simulate/visualize.py)
- ``cli``:      command-line driver with the reference's command surface
                (reference: main.py)
"""

__version__ = "0.1.0"
