"""Serving: sampling, the continuous-batching engines (slotted and
paged), the native runtime bindings and the HTTP front end."""
