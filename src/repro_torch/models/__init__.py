"""Models of the port: so far DLRM (``dlrm``) and the layer helpers it
uses (``layers``)."""
