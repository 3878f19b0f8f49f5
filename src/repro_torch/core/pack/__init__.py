"""IMPack: bit-packed and compressed-at-rest RRR arenas
(``repro.core.pack``).

Importing this package registers the packed and compressed selection
strategies in `repro_torch.core.selection` (the engine imports it);
`repro_torch.core.store.make_store` builds the stores.
"""
from repro_torch.core.pack.codec import (  # noqa: F401
    BitmapCodec,
    PackedCodec,
    TokenCodec,
    codec_for,
    pack_bits,
    pack_bits_np,
    tokens_needed,
    unpack_bits,
    unpack_bits_np,
)
from repro_torch.core.pack.stores import (  # noqa: F401
    CodecStore,
    CompressedStore,
    PackedBitmapStore,
)
from repro_torch.core.pack.selection import select_codec  # noqa: F401
