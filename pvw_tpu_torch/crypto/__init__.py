from .decryption import decode_scalar_pvw_rns, decrypt_party_shares, decrypt_party_value
from .encryption import (
    PvwCiphertext,
    encrypt,
    encrypt_all_party_shares,
    encrypt_all_party_shares_batched,
    encrypt_batch,
    encrypt_broadcast,
    encrypt_party_shares,
)
from .threshold import decrypt_valid_shares, select_valid_ciphertexts

__all__ = [
    "PvwCiphertext", "decode_scalar_pvw_rns", "decrypt_party_shares",
    "decrypt_party_value", "encrypt", "encrypt_all_party_shares",
    "encrypt_all_party_shares_batched", "encrypt_batch", "encrypt_broadcast",
    "encrypt_party_shares", "select_valid_ciphertexts", "decrypt_valid_shares",
]
