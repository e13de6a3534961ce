from .public_key import GlobalPublicKey, Party, PublicKey, PublicKeyRows
from .secret_key import SecretKey

__all__ = ["GlobalPublicKey", "Party", "PublicKey", "PublicKeyRows", "SecretKey"]
