from repro_torch.kernels.ckpt_codec.ops import (  # noqa: F401
    BLOCK, DIGEST_ALG, bf16_encode_digest, classifier_lanes, delta_decode,
    delta_encode, delta_encode_digest, digest_blocks, digest_weights,
    fold_digest, payload_digest)
