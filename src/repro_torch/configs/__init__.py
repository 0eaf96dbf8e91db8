"""Architecture configs, copied from ``repro.configs`` (data only);
``registry.config("llama3-8b", attn_impl="flash")`` resolves here."""
