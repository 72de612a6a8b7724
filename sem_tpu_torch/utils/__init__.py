"""Host-side helpers: disk cache of solver constants, device constants."""
