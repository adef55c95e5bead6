from repro_torch.graphstore.stores import GraphStore, LabelRegistry, PropertyStore, RelationshipStore  # noqa: F401
from repro_torch.graphstore.blob import Blob, BlobStore, BlobValueManager  # noqa: F401
from repro_torch.graphstore.wal import WriteAheadLog  # noqa: F401
