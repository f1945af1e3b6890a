"""Host-side message planning and plain torch lanes (counterpart of
``tpuminter.ops``)."""
