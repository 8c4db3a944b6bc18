"""WebUI of the port (``alink_tpu.webui``): experiment CRUD + DAG
build/run/inspect over the op catalog, the serving surface and
``GET /metrics``.

Capability parity with the reference's WebUI (reference: webui/server/src/
main/java/com/alibaba/alink/server/ServerApplication.java — Spring-Boot REST
over experiment/node/edge JPA repositories, running Alink jobs embedded;
webui/web/ — React DAG canvas): a thin stdlib-http JSON API plus one static
page. Experiments persist as a JSON file; running one builds the operator
DAG by name and collects every node's output table head for inspection."""

from .server import ExperimentStore, WebUIServer, run_experiment

__all__ = ["ExperimentStore", "WebUIServer", "run_experiment"]
