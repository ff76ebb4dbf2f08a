"""Model description (``cnn_spec``) and the Table-I energy model
(``energy``) — the numpy-only parts of the chip twin the runtime needs."""
