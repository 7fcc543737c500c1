"""Control-plane pieces of the port: the weight-version registry
(``weight_transfer``) and the KV-migration handle (``kv_migration``)."""
