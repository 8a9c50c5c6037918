"""The one-device part of the reference's `parallel`: the chunked
cross-entropy (`losses`)."""
